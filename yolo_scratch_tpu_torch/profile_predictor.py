"""Where a Predictor batch spends its time on the card.

    python -m yolo_scratch_tpu_torch.profile_predictor [--batch 32] [--imgsz 640] [--out DIR]

For each row (crater ch=1/nc=5, COCO ch=3/nc=80; YOLO11n, seeded init,
bf16, BN folded) it times whole batches on the host clock, and traces
whole ``Predictor.predict_batch`` calls with ``torch.profiler`` for the
device time per batch, its share of the wall time, the top kernels, and
the device ms per batch under each of the program's spans (``yst.h2d``,
``yst.normalize``, ``yst.model``, ``yst.select``, ``yst.nms``,
``yst.pack``; ``utils/profiling.py``). Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig, load_deploy_model
from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.utils.profiling import SPAN_PREFIX

ROWS = [("crater", "yolo11_crater.json", 1, 5), ("coco", "yolo11_coco.json", 3, 80)]


def wall_ms(pred: Predictor, x: np.ndarray, batches: int = 20) -> float:
    """Host-clock ms per back-to-back predict_batch call, ending in a sync."""
    pred.predict_batch(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        pred.predict_batch(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / batches


def trace(pred: Predictor, x: np.ndarray, out_dir: Path | None, tag: str, batches: int = 5):
    """Device ms per predict_batch call (kernels and copies, from a
    ``torch.profiler`` trace of ``batches`` calls), the top device
    activities by time, and the device ms per call launched under each of
    the program's ``yst.*`` spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred.predict_batch(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            pred.predict_batch(x)
        torch.cuda.synchronize()
    # device-side rows only (kernels, memcpys); the CPU op rows repeat their
    # children's device time, and CUPTI's own buffer requests and the spans'
    # rows on the card's timeline are not work
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key
           and not e.key.startswith(SPAN_PREFIX)]
    dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    spans: dict = {}
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX) and e.device_type == DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total / 1e3 / batches
    if out_dir is not None:
        prof.export_chrome_trace(str(out_dir / f"trace_{tag}.json"))
    return {
        "device_ms_per_batch": sum(e.self_device_time_total for e in dev) / 1e3 / batches,
        "device_ops_per_batch": sum(e.count for e in dev) // batches,
        "top": [(e.key[:120], e.self_device_time_total / 1e3 / batches, e.count // batches)
                for e in dev[:12]],
        "spans_ms": spans,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--out", type=str, default=None, help="directory for traces")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_predictor needs a CUDA GPU")
    torch.backends.cudnn.benchmark = True
    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    cfg = PredictorConfig(img_size=args.imgsz, batch_size=args.batch, conf_threshold=args.conf)
    report = {"device": torch.cuda.get_device_name(0), "batch": args.batch,
              "imgsz": args.imgsz, "conf": args.conf, "rows": {}}
    for name, cfg_file, ch, nc in ROWS:
        model = load_deploy_model(CONFIGS / cfg_file, ch=ch, nc=nc, seed=0, device="cuda")
        pred = Predictor(model, cfg, device="cuda")
        x = np.random.RandomState(ch).randint(0, 256, (args.batch, args.imgsz, args.imgsz, ch),
                                              dtype=np.uint8)
        row = {"wall_ms_per_batch": wall_ms(pred, x), **trace(pred, x, out_dir, name)}
        row["device_busy_share"] = row["device_ms_per_batch"] / row["wall_ms_per_batch"]
        report["rows"][name] = row
        print(name, json.dumps(row), flush=True)
    if out_dir is not None:
        (out_dir / "profile_predictor.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
