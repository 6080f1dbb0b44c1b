"""Deploy throughput of any YOLO11 or YOLOX scale (port of
``scripts/bench_scale.py``).

    python -m yolo_scratch_tpu_torch.bench.scale [--scale s] [--batch 64] [--model yolox]

The headline's contract (uint8 in, bf16, BN folded, exact top-k, conf 0.25,
IoU 0.45, 300 detections), parameterised by scale, through the Predictor's
own dispatch: YOLO11 takes the fused select-then-decode, YOLOX its f32
decode and the common postprocess (the paper config, ch=3 / nc=80). Both
sweep with kernel #1, where the JAX script takes XLA's sweep. ``nscan``
batches a launch, 6 launches a window, best of 3.

Prints one JSON line: ``model``, ``scale``, ``batch``, ``imgsz``,
``params`` (of the unfolded model), ``images_per_sec_per_chip`` (the best
window), plus ``median``, ``windows``, ``nms_launches``,
``valid_per_image`` and ``device``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.bench.headline import deploy_program
from yolo_scratch_tpu_torch.models.yolox import SCALES, build_yolox, scale_name
from yolo_scratch_tpu_torch.utils.device import resolve_device

ITERS = 6


def build(model_kind: str, scale: str, cfg: str | None, ch: int | None, nc: int | None,
          img: int, device):
    """(model, ch) as the JAX script builds them: YOLOX at ch=3 / nc=80;
    YOLO11 from ``cfg`` (default crater), ch/nc 3/80 for a COCO config
    and 1/5 otherwise unless given."""
    if model_kind == "yolox":
        yx = scale_name(scale)
        if yx not in SCALES:
            raise SystemExit(f"unknown YOLOX scale {scale!r}; choose from {sorted(SCALES)} "
                             "(or 'n' for nano)")
        return build_yolox(yx, nc=80, ch=3, seed=0, device=device), 3
    cfg = cfg or str(C.CRATER_CFG)
    coco = "coco" in Path(cfg).name
    ch = ch if ch is not None else (3 if coco else 1)
    nc = nc if nc is not None else (80 if coco else 5)
    return C.deploy_model(ch, nc, scale, img, device=device, cfg=cfg), ch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Deploy throughput at any scale "
                                             "(scripts/bench_scale.py)")
    ap.add_argument("--scale", default="s")
    ap.add_argument("--model", default="yolo11", choices=["yolo11", "yolox"])
    ap.add_argument("--cfg", default=None,
                    help="YOLO11 config json (default: crater ch=1 nc=5; yolo11_coco.json "
                         "gives ch=3 nc=80)")
    ap.add_argument("--ch", type=int, default=None)
    ap.add_argument("--nc", type=int, default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--nscan", type=int, default=4)
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    img, B, S = args.imgsz, args.batch, args.nscan

    model, ch = build(args.model, args.scale, args.cfg, args.ch, args.nc, img, dev)
    # the unfolded model's: conv kernels, BN scales and biases, the head's
    # biases, the tree the JAX script counts
    n_params = sum(p.numel() for p in model.parameters())
    _, program = deploy_program(model, B, 512, dev, img=img)
    xs = C.uint8_batches((S, B, img, img, ch), dev)
    rates, out, launches = C.scan_windows(program, xs, ITERS, dev)
    m = C.spread(rates)
    return C.emit({
        "model": args.model, "scale": args.scale, "batch": B, "imgsz": img, "params": n_params,
        "images_per_sec_per_chip": round(m["best"], 2), "median": m["median"],
        "windows": m["windows"], "nms_launches": launches,
        "valid_per_image": C.valid_per_image(out), "device": C.device_block(dev)})


if __name__ == "__main__":
    main()
