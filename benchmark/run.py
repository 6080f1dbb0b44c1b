"""Run one cell of the benchmark and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. One process, one
run: set-up (imports, weights and traffic from the seed, the program's
set-up, every shape warmed up) is ``setup_s``; then the window of
``--seconds``; then the check against the plain reference. With
``--trace 1`` the window runs under the profiler and the line carries the
cell's per-layer metrics instead of its end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and last ``check``,
each compared number with its limit. The same numbers close standard
error.

Exits 2 without a result where no CUDA device is visible or fewer than the
cell's chips are, and 3 where the JAX package, JAX or flax is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Tuple

FORBIDDEN = {"jax", "jaxlib", "flax", "yolo_scratch_tpu"}


class Run:
    """What a driver gets: the configuration, the traffic mix, the seed, the
    window, the device, and the program's predictor factory."""

    def __init__(self, cfg, traffic, seed: int, seconds: float, trace: bool, device,
                 t0: float, make_predictor=None, make_step=None):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.setup_s: float | None = None
        if make_predictor is not None:
            self.make_predictor = make_predictor
        if make_step is not None:
            self.make_step = make_step

    def mark_setup(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_s = time.perf_counter() - self.t0

    @staticmethod
    def make_predictor(model, pcfg, device):
        """The program's deploy entry for a model."""
        from yolo_scratch_tpu_torch.infer import Predictor

        return Predictor(model, pcfg, device=device)

    @staticmethod
    def make_step(model, cfg, precision):
        """The program's train step and state for a model."""
        from benchmark.drivers.train import build_step

        return build_step(model, cfg, precision)


def execute(spec, cell: Dict[str, Any], seed: int, seconds: float, trace: bool, device,
            t0: float, make_predictor=None) -> Dict[str, Any]:
    """Set-up, window and check of one run of ``cell``: the driver's record,
    with ``setup_s`` among its end-to-end metrics."""
    import importlib

    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    run = Run(cfg, traffic, seed, seconds, trace, device, t0, make_predictor)
    rec = driver.run(run)
    rec["e2e"]["setup_s"] = run.setup_s
    return rec


def device_name(device) -> str:
    import platform

    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return platform.processor() or platform.machine()


def power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def result(spec, cell: Dict[str, Any], rec: Dict[str, Any], trace: bool,
           device) -> Tuple[Dict[str, Any], List[str]]:
    """The result line and the lines that close standard error."""
    from benchmark import check
    from benchmark.spec import reader

    kind = "per_layer" if trace else "end_to_end"
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in spec.metrics_for(cell["name"], kind):
        if trace:
            value = reader(m["name"], spec.here).read(rec)
        else:
            value = rec["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = spec.limits(cell["name"])
    ok, lines = check.verdict(rec["numbers"], limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_name(device), "count": int(cell["chips"]),
           "memory_peak_bytes": int(rec.get("memory_peak_bytes", 0))}
    line: Dict[str, Any] = {"correct": ok, "attempted": int(rec["attempted"]),
                            "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    if trace:
        tr = rec["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    line["check"] = {k: {"value": rec["numbers"].get(k), "limit": limits.get(k)}
                     for k in sorted(set(rec["numbers"]) | set(limits))}
    notes = list(rec.get("notes", []))
    notes.append(f"power.limit {power_limit() if device.type == 'cuda' else None}")
    return line, notes + lines


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rec = execute(spec, cell, args.seed, args.seconds, bool(args.trace), device, t0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {bad}", file=sys.stderr)
        return 3
    line, lines = result(spec, cell, rec, bool(args.trace), device)
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
