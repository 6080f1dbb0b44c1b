"""int8 against bf16 deploy throughput per YOLO11 scale, in one process
(port of ``scripts/bench_int8_scales.py``).

    python -m yolo_scratch_tpu_torch.bench.int8_scales [--scales m l x] [--out FILE]

For each scale, the headline's deploy pipeline (uint8 -> forward -> fused
decode -> kernel #1) in bf16, then int8 (``nn/quant.py`` PTQ on random
calibration; the quantized convs run ``ops/int8_conv.py``), B=64 x nscan 4
a launch, 6 launches a window, best of 3. ``compile_s`` is the first
launch's seconds (cuDNN's algorithm search and the kernels' build on the
card; nothing is compiled ahead).

Prints one JSON line ``{"rows", "summary", "protocol", "device"}``: a row
per (scale, dtype) with ``images_per_sec_per_chip`` and its windows, and
``int8_vs_bf16`` per scale. ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.bench.headline import deploy_program
from yolo_scratch_tpu_torch.utils.device import resolve_device

ITERS = 6


def bench_one(scale: str, quant: bool, batch: int, nscan: int, img: int, ch: int, nc: int,
              dev) -> dict:
    model = C.deploy_model(ch, nc, scale, img, quant, dev)
    _, program = deploy_program(model, batch, 512, dev, img=img)
    xs = C.uint8_batches((nscan, batch, img, img, ch), dev)
    t0 = time.perf_counter()
    C.fetch(program(xs), dev)
    compile_s = time.perf_counter() - t0
    rates, out, launches = C.scan_windows(program, xs, ITERS, dev, warmup=1)
    m = C.spread(rates)
    return {"scale": scale, "dtype": "int8" if quant else "bf16", "batch": batch, "imgsz": img,
            "images_per_sec_per_chip": round(m["best"], 2), "median": m["median"],
            "windows": m["windows"], "compile_s": round(compile_s, 1),
            "nms_launches": launches, "valid_per_image": C.valid_per_image(out)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="int8 vs bf16 per scale "
                                             "(scripts/bench_int8_scales.py)")
    ap.add_argument("--scales", nargs="+", default=["m", "l", "x"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--nscan", type=int, default=4)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--ch", type=int, default=1)
    ap.add_argument("--nc", type=int, default=5)
    ap.add_argument("--out", type=str, default=None, help="also write the JSON here")
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = [bench_one(scale, quant, args.batch, args.nscan, args.imgsz, args.ch, args.nc, dev)
            for scale in args.scales for quant in (False, True)]
    by_scale = {}
    for r in rows:
        by_scale.setdefault(r["scale"], {})[r["dtype"]] = r["images_per_sec_per_chip"]
    summary = {s: {**v, "int8_vs_bf16": round(v["int8"] / v["bf16"], 3)}
               for s, v in by_scale.items()}
    out = {"rows": rows, "summary": summary,
           "protocol": f"u8->dets headline pipeline, B={args.batch} x{args.nscan}/launch @ "
                       f"{args.imgsz}, one process, best of 3 windows",
           "device": C.device_block(dev)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2))
    return C.emit(out)


if __name__ == "__main__":
    main()
