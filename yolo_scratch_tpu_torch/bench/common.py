"""Shared pieces of the benches: the deploy model and program, seeded
uint8 batches made on the device, timed windows, the device block every
JSON line carries, and kernel #1's launch counter.

Timing: each window runs its work back to back and ends in
``torch.cuda.synchronize()`` and a fetch of the last output to the host;
the host clock runs around it, after warm-up calls (which also let cuDNN
pick its algorithms and build the NMS kernels). Every line reports each
window's value, the best and the median.
"""

from __future__ import annotations

import contextlib
import json
import platform
import statistics
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterator, List

import numpy as np
import torch

from yolo_scratch_tpu_torch.host import PredictorConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.ops import nms_kernels as K

CRATER_CFG = CONFIGS / "yolo11_crater.json"


def power_limit() -> str | None:
    """``power.limit`` as nvidia-smi reports it (``"700.00 W"``), or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def device_block(dev: torch.device) -> dict:
    """What every JSON line says of where it ran: ``platform`` "gpu" or
    "cpu", the device's name, the device count and the card's power limit."""
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count(), "power_limit": power_limit()}
    return {"platform": "cpu", "kind": platform.processor() or platform.machine(),
            "count": 1, "power_limit": None}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fetch(out, dev: torch.device):
    """Wait for the device, then copy ``out``'s tensors (any nesting of
    lists and tuples) to the host."""
    sync(dev)
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, (list, tuple)):
        return [fetch(o, dev) for o in out]
    return out


def timed_windows(run: Callable[[], object], dev: torch.device, windows: int = 3,
                  warmup: int = 2) -> tuple[List[float], object]:
    """``warmup`` calls of ``run``, then ``windows`` timed calls, each on
    the host clock up to the fetch of its output: (seconds of each window,
    the last window's output on the host)."""
    for _ in range(warmup):
        fetch(run(), dev)
    secs, out = [], None
    for _ in range(windows):
        t0 = time.perf_counter()
        out = fetch(run(), dev)
        secs.append(time.perf_counter() - t0)
    return secs, out


def spread(values: List[float]) -> dict:
    """``best`` (the largest rate), ``median`` and every window's value."""
    return {"best": max(values), "median": statistics.median(values), "windows": list(values)}


def uint8_batches(shape, dev: torch.device, seed: int = 0) -> torch.Tensor:
    """Seeded uint8 images of ``shape``, drawn on ``dev`` (no host buffer
    of floats first)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=dev, generator=gen)


def deploy_model(ch: int, nc: int, scale: str = "n", img: int = 640, int8: bool = False,
                 device: torch.device = torch.device("cpu"), cfg: str | Path = CRATER_CFG,
                 seed: int = 0):
    """The seeded YOLO11 of the benches on ``device``; with ``int8``,
    BN-folded and int8-quantized (``nn/quant.py``) on the JAX benches'
    calibration, 4 random images (the scales do not matter to a throughput
    measurement). The Predictor folds BN and casts the rest."""
    model = build_yolo11(cfg, ch=ch, nc=nc, scale=scale, seed=seed, device=device)
    if int8:
        from yolo_scratch_tpu_torch.nn.quant import quantize_for_deploy

        calib = np.random.RandomState(1).randint(0, 256, (4, img, img, ch)).astype(np.float32)
        model = quantize_for_deploy(model, [calib / 255.0])
    return model


def deploy_config(img: int, batch: int, topk: int = 512, dtype: torch.dtype = torch.bfloat16,
                  conf: float = 0.25) -> PredictorConfig:
    """The benches' deploy settings: IoU 0.45, 300 detections, exact top-k
    selection, BN folded, uint8 in, kernel #1 at every batch size."""
    return PredictorConfig(img_size=img, batch_size=batch, conf_threshold=conf,
                           iou_threshold=0.45, max_det=300, pre_nms_topk=topk,
                           bf16=dtype == torch.bfloat16, blocked_topk=0, nms_impl="kernel")


def scan_program(infer: Callable) -> Callable:
    """``xs (nscan, B, S, S, C) -> [infer(xs[i]) for each i]``: every batch
    fully processed, one after another (the JAX benches' ``lax.scan``)."""
    def run(xs):
        with torch.inference_mode():
            return [infer(x) for x in xs]
    return run


def scan_windows(program: Callable, xs: torch.Tensor, iters: int, dev: torch.device,
                 windows: int = 3, warmup: int = 2) -> tuple[List[float], object, int]:
    """Time ``iters`` launches of ``program(xs)`` (a :func:`scan_program`)
    a window: (img/s of each window, the last window's output on the host,
    kernel #1's launches over the warm-up and timed launches)."""
    def window():
        out = None
        for _ in range(iters):
            out = program(xs)
        return out

    with kernel1_launches() as k1:
        secs, out = timed_windows(window, dev, windows, warmup)
    images = xs.shape[0] * xs.shape[1] * iters
    return [images / s for s in secs], out, k1["launches"]


def valid_per_image(outs) -> float:
    """Mean valid detections per image over fetched ``(boxes, scores,
    labels, valid)`` outputs."""
    valid = torch.cat([o[3].reshape(-1, o[3].shape[-1]) for o in outs])
    return float(valid.sum()) / valid.shape[0]


@contextlib.contextmanager
def kernel1_launches() -> Iterator[dict]:
    """Kernel #1's launches inside the block: ``count["launches"]`` once it
    ends (CUDA tensors only; the CPU runs its plain version)."""
    count = {"launches": 0}
    start = K.launches["nms_sweep_batched"]
    try:
        yield count
    finally:
        count["launches"] = K.launches["nms_sweep_batched"] - start


def emit(result: dict) -> dict:
    """Print ``result`` as the one JSON line and return it."""
    print(json.dumps(result), flush=True)
    return result
