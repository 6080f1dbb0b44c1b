"""The readings that the check's limits are set from, for one cell, many
seeds in one process:

* the program as the cell runs it (the sound runs; their largest reading
  of each number is its lower reading);
* the controls: the program's own int8 path (``nn/quant.py``, calibrated
  on one pool batch) in place of its bf16 forward, for ``feat_err``; the
  plain postprocess computed in bf16 in place of the program's f32 one,
  for ``post_mismatch`` (``post_mismatch.bf16``). Their smallest reading
  is the upper one.

    python -m benchmark.control --workload <cell> --seeds 12 [--seconds 2] \\
        [--first-seed N] [--out control_<cell>.json]

Each seed runs set-up, a short window at the cell's own load and the
check, as ``benchmark/run.py`` does. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np


def int8_predictor(model, pcfg, device, calib):
    """The program's int8 Predictor, calibrated on ``calib``, one batch of
    the cell's own traffic as float32 in [0, 1]."""
    from yolo_scratch_tpu_torch.infer import Predictor
    from yolo_scratch_tpu_torch.nn.quant import quantize_for_deploy

    return Predictor(quantize_for_deploy(model, [calib]), pcfg, device=device)


def _faulty(model, pcfg, device, wrap):
    from benchmark.run import Run

    return wrap(Run.make_predictor(model, pcfg, device))


@contextlib.contextmanager
def tf32_on():
    """TF32 for cuBLAS and cuDNN inside (the program's step, built without a
    precision scope, then runs in TF32)."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def deploy_row(driver, cfg, traffic, seed, seconds, dev, control: bool) -> dict:
    """The program as the cell runs it; with ``control``, its int8 path and
    each of ``faults.DEPLOY_FAULTS`` planted."""
    import torch

    from benchmark.faults import DEPLOY_FAULTS
    from benchmark.run import Run
    from benchmark.traffic import scenes
    from benchmark.weights import generator

    row = {}
    for arm in ("program", "int8", *DEPLOY_FAULTS) if control else ("program",):
        make = None
        if arm in DEPLOY_FAULTS:
            make = functools.partial(_faulty, wrap=DEPLOY_FAULTS[arm])
        if arm == "int8":
            img = scenes.draw(cfg, traffic, generator(seed, dev, "traffic"),
                              int(traffic["batch"]), dev)[0]
            calib = ((img * 255.0 + 0.5).floor() / 255.0).cpu().numpy()
            make = functools.partial(int8_predictor, calib=calib)
        run = Run(cfg, traffic, seed, seconds, False, dev, time.perf_counter(), make)
        d = driver.Deploy(run)
        run.mark_setup()
        rec = d.measure(seconds, False)
        nums = d.judge(rec, control=(arm == "program" and control))
        row[arm] = dict(nums, img_per_s=rec["e2e"]["img_per_s"],
                        batch_ms_p95=rec["e2e"]["batch_ms_p95"], setup_s=run.setup_s,
                        memory_peak_bytes=rec.get("memory_peak_bytes"))
        del d
        torch.cuda.empty_cache()
    return row


def train_row(driver, cfg, traffic, seed, dev, control: bool) -> dict:
    """The program's first three steps as the cell runs them; with
    ``control``, again with the step's precision scope off and TF32 on, and
    with each of ``faults.TRAIN_FAULTS`` planted."""
    import torch

    from benchmark.faults import TRAIN_FAULTS
    from benchmark.run import Run

    row = {}
    for arm in ("program", "tf32", *TRAIN_FAULTS) if control else ("program",):
        run = Run(cfg, traffic, seed, 0.0, False, dev, time.perf_counter(),
                  make_step=TRAIN_FAULTS.get(arm))
        if arm == "tf32":
            with tf32_on():
                t = driver.Train(run, precision=None)
        else:
            t = driver.Train(run)
        rec: dict = {}
        row[arm] = dict(t.judge(rec), excluded=len(rec["excluded_leaves"]), **rec["steps"])
        del t
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings behind a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=4,
                    help="the first N seeds also run the control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec()
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device("cuda", 0)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        if traffic["driver"] == "train":
            row = train_row(driver, cfg, traffic, seed, dev, i < args.control_seeds)
        else:
            row = deploy_row(driver, cfg, traffic, seed, args.seconds, dev,
                             i < args.control_seeds)
        row["seed"] = seed
        print(json.dumps(row), flush=True)
        rows.append(row)
    ctrl = "tf32" if traffic["driver"] == "train" else "int8"
    names = [k for k in rows[0]["program"] if k in spec.limits(args.workload)]
    summary = {
        "lower": {k: max(r["program"][k] for r in rows) for k in names},
        "median": {k: float(np.median([r["program"][k] for r in rows])) for k in names},
        "control": {k: min(r[ctrl][k] for r in rows if ctrl in r) for k in names},
        "faults": {arm: {k: min(r[arm][k] for r in rows if arm in r) for k in names}
                   for arm in rows[0] if arm not in ("program", ctrl, "seed")},
        "device": torch.cuda.get_device_name(dev),
    }
    if ctrl == "int8":
        summary["control"]["post_mismatch"] = min(r["program"]["post_mismatch.bf16"]
                                                  for r in rows if "int8" in r)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
