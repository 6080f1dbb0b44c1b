"""Small runs of the harness for the CPU tests: a cell's configuration at
its published widths, with the mix cut to a few small images and the
Predictor on its f32 path."""

from __future__ import annotations

import time

import torch

from benchmark.run import Run, result
from benchmark.spec import Spec

SMALL = {"img_size": 64, "batch": 2, "pool": 2, "check_batches": 2, "inflight": 2,
         "max_det": 20, "trace_seconds": 1}


def f32_predictor(model, pcfg, device):
    """The program's Predictor on its f32 path: the CPU's bf16 kernels round
    otherwise than cuDNN's, so the harness's logic is tested in f32 here and
    its bf16 numbers are read on the card."""
    pcfg.bf16 = False
    return Run.make_predictor(model, pcfg, device)


def small_run(cell: str, seconds: float = 0.5, trace: bool = False, seed: int = 2**31 + 5,
              make_predictor=None, make_step=None, traffic=None, spec: Spec | None = None):
    """(result line, stderr lines, record) of one CPU run of ``cell``."""
    import importlib

    spec = spec or Spec()
    c = spec.cell(cell)
    cfg = spec.config(c["config"])
    tr = dict(spec.traffic(c["traffic"]), **SMALL)
    tr["pre_nms_topk"] = min(int(tr.get("pre_nms_topk", 64)), 64)
    if tr["driver"] == "train":
        tr["pool"] = 4
    tr.update(traffic or {})
    driver = importlib.import_module(f"benchmark.drivers.{tr['driver']}")
    run = Run(cfg, tr, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
              make_predictor or f32_predictor, make_step)
    rec = driver.run(run)
    rec["e2e"]["setup_s"] = run.setup_s
    line, lines = result(spec, c, rec, trace, torch.device("cpu"))
    return line, lines, rec
