"""Serving-artifact throughput: the ``torch.export`` artifact against the
live Predictor (port of ``scripts/bench_export.py``).

    python -m yolo_scratch_tpu_torch.bench.export [--batch 128] [--nscan 8]

Exports the headline deploy program (YOLO11n crater row at 640, uint8 ->
detections, conf 0.25, top-512, kernel #1 through the ``yst`` op), saves
it, loads it back in the same process, and times both the live Predictor
and the loaded artifact on the same seeded batches: ``nscan`` batches a
launch, 8 launches a window, best of 3 each. The claim under test: the
artifact runs the same program, so it costs nothing.

Prints one JSON line: ``metric``, ``live``, ``artifact``, ``ratio``,
``artifact_mb``, ``batch``, plus each side's median and windows, kernel
#1's launches and ``device``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.bench.headline import deploy_program
from yolo_scratch_tpu_torch.export import ArtifactPredictor, export_predictor, load_artifact, save_artifact
from yolo_scratch_tpu_torch.utils.device import resolve_device

IMG, ITERS = 640, 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="torch.export artifact vs live "
                                             "(scripts/bench_export.py)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--nscan", type=int, default=8)
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, nscan = args.batch, args.nscan

    pred, live = deploy_program(C.deploy_model(1, 5, "n", IMG, device=dev), B, 512, dev,
                                img=IMG)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench_export.pt2")
        nbytes = save_artifact(export_predictor(pred), path)
        art = ArtifactPredictor(load_artifact(path))
    served = C.scan_program(art._infer)
    xs = C.uint8_batches((nscan, B, IMG, IMG, 1), dev)

    live_r, _, live_k1 = C.scan_windows(live, xs, ITERS, dev)
    art_r, _, art_k1 = C.scan_windows(served, xs, ITERS, dev)
    live_m, art_m = C.spread(live_r), C.spread(art_r)
    return C.emit({
        "metric": "export_artifact_vs_live_images_per_sec",
        "live": round(live_m["best"], 2), "artifact": round(art_m["best"], 2),
        "ratio": round(art_m["best"] / live_m["best"], 4),
        "artifact_mb": round(nbytes / 1e6, 2), "batch": B,
        "live_windows": live_m["windows"], "live_median": live_m["median"],
        "artifact_windows": art_m["windows"], "artifact_median": art_m["median"],
        "nms_launches": {"live": live_k1, "artifact": art_k1}, "device": C.device_block(dev)})


if __name__ == "__main__":
    main()
