"""Trace the deploy-path forward with ``torch.profiler`` and print the top
device kernels (port of ``scripts/profile_forward.py``, with its flags).

The model is the crater YOLO11n (ch=1, nc=5), seeded init, BN folded, bf16,
as the Predictor holds it; the input a seeded f32 batch in [0, 1) cast to
bf16 on the device. Without ``--full`` each call is the forward, its maps
summed; with ``--full`` it is the Predictor's program after the forward:
``ops/decode.py::postprocess_from_feats`` on the f32 maps (conf 0.25, IoU
0.45, 300 detections, K=512) through NMS kernel #1 (``nms_impl="kernel"``;
the JAX script takes XLA's pairwise sweep there).

Two warm-up calls, then ``--iters`` calls under ``torch.profiler`` (CPU and
CUDA activities, ``record_shapes``), each in a ``record_function`` range,
ending in one sync. The Chrome trace (``*.pt.trace.json``, with the device
block and the run's shapes as metadata) goes under ``yst_trace`` in the
temporary directory; ``parse_trace`` reads it. Prints the kernel events,
their total device ms and ms per call, the top ``--top`` kernels by self
time per call, and a JSON line with a ``device`` block. On the CPU
(``--device cpu``) the table reads CPU ops' self times instead.

    python -m yolo_scratch_tpu_torch.profile_forward [--batch 128] [--imgsz 640] [--top 40]
        [--full] [--iters 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.infer import Predictor
from yolo_scratch_tpu_torch.ops.decode import postprocess_from_feats
from yolo_scratch_tpu_torch.utils.device import resolve_device
from yolo_scratch_tpu_torch.utils.profiling import SPAN_PREFIX, export_trace, trace_dir

RANGE = "profile_forward"
COPIES = ("Memcpy", "Memset")  # device activities that are not kernels


def build(batch: int, imgsz: int, full: bool, dev: torch.device, conf: float = 0.25):
    """(the Predictor holding the folded bf16 model, the f32 input batch on
    ``dev``, the profiled call). The call returns the summed maps, or with
    ``full`` the (boxes, scores, labels, valid) of ``postprocess_from_feats``."""
    ch, nc = 1, 5
    pred = Predictor(C.deploy_model(ch, nc, "n", imgsz, device=dev),
                     C.deploy_config(imgsz, batch, conf=conf), device=dev)
    m = pred.model
    x = torch.as_tensor(np.random.RandomState(0).rand(batch, imgsz, imgsz, ch)
                        .astype(np.float32), device=dev)

    @torch.inference_mode()
    def fn():
        feats = m(x.to(torch.bfloat16))
        if not full:
            return sum(f.float().sum() for f in feats)
        return postprocess_from_feats(
            [f.float() for f in feats], nc=nc, strides=m.strides, img_size=imgsz,
            reg_max=m.reg_max, conf_threshold=conf, iou_threshold=0.45, max_det=300,
            pre_nms_topk=512, nms_impl="kernel")

    return pred, x, fn


def device_rows(prof, dev: torch.device) -> list:
    """``(name, self us, count)`` of the trace's kernels on the card (copies,
    the profiler's own buffers and the ranges' spans on the card's timeline
    left out), or of its CPU ops on the CPU (the ranges left out: this
    script's and the program's ``yst.*`` spans)."""
    from torch.autograd import DeviceType

    def is_range(key):
        return key == RANGE or key.startswith(SPAN_PREFIX)

    if dev.type == "cuda":
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key
                and not e.key.startswith(COPIES) and not is_range(e.key)]
    else:
        rows = [(e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                if not is_range(e.key)]
    return sorted(rows, key=lambda r: -r[1])


def main(argv=None, conf: float = 0.25, out_dir=None) -> dict:
    """``conf`` is the score threshold of ``--full``; ``out_dir`` the trace
    directory (default ``yst_trace`` under the temporary directory)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description="torch.profiler trace of the deploy forward")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--full", action="store_true",
                    help="profile the full infer (incl. postprocess), not just forward")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, _, fn = build(args.batch, args.imgsz, args.full, dev, conf)

    print("warming up...", flush=True)
    C.fetch(fn(), dev)
    C.fetch(fn(), dev)
    print("tracing...", flush=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with C.kernel1_launches() as k1, profile(activities=activities, record_shapes=True) as prof:
        for _ in range(args.iters):
            with record_function(RANGE):
                out = fn()
        C.sync(dev)
        path = export_trace(prof, out_dir or trace_dir("yst_trace"), "profile_forward",
                            yst_device=C.device_block(dev),
                            yst_run=dict(batch=args.batch, imgsz=args.imgsz, iters=args.iters,
                                         full=args.full))
    print("parsing...", flush=True)
    rows = device_rows(prof, dev)
    total, events = sum(us for _, us, _ in rows) / 1e3, sum(n for _, _, n in rows)
    what = "kernel" if dev.type == "cuda" else "CPU op"
    print(f"{what} events: {events}; total {what} time {total:.3f} ms over {args.iters} iters "
          f"({total / args.iters:.3f} ms/iter)", flush=True)
    top = [[name[:140], us / 1e3 / args.iters] for name, us, _ in rows[: args.top]]
    for name, ms in top:
        print(f"{ms:9.3f} ms/iter  {name}")
    result = dict(batch=args.batch, imgsz=args.imgsz, full=args.full, iters=args.iters,
                  conf=conf, events=events, total_ms=total, ms_per_iter=total / args.iters,
                  top=top,
                  nms_launches=k1["launches"], trace=str(path),
                  valid_per_image=(float(out[3].sum()) / args.batch if args.full else None),
                  device=C.device_block(dev))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
