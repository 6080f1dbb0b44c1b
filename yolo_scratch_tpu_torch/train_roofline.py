"""Per-stage table of the train step from a ``torch.profiler`` trace (port
of ``scripts/train_roofline.py``, with its flags and stages). Pure parsing.

Reads the newest ``*.pt.trace.json`` under ``--dir`` (``profile_train``'s
default directory). Each GPU kernel is put in a train-step stage by the
input shapes of the CPU op that launched it (linked through the trace's
external IDs, or its correlation IDs through the runtime's launch events),
with the batch B, image size S and ground-truth slots G that
``profile_train`` writes into the trace (else 64, 640, 24):

* layout kernels (NCHW<->NHWC conversions, copies) -> "layout/copy";
* an anchor dimension ((S/8)^2 + (S/16)^2 + (S/32)^2 or one level's: 8400,
  6400, 1600, 400 at 640) in a rank-2 or rank-3 input -> "TAL (B,A,G)" if a
  G or 100 dimension is also there, else "head/loss per-anchor";
* an NCHW (., C, H, W) input with H and W among S/2 .. S/32 -> "model
  spatial (fwd+bwd)", and so are convolution and max-pool ops;
* a (B, G, .) input -> "GT preprocess";
* inputs of at most 2^22 elements -> "param-shaped (wgrad+opt)". Caveat, as
  in the JAX script: shapes alone cannot split the optimizer and EMA from
  other small ops; classified by their inputs, weight-gradient kernels of
  the convolutions fall under the spatial stage here;
* memcpy / memset -> "copy/dma"; anything else -> "other".

The whole-step line is the GPU span of the trace's ``train_step`` ranges
(their CPU span in a CPU trace). The stage shares sum to 100%. A trace
with no device events (``--device cpu``) is read through its CPU ops' self
times, each op classified by its own inputs. The last line is JSON with
the trace's ``device`` block.

    python -m yolo_scratch_tpu_torch.train_roofline [--iters 5] [--dir DIR] [--top 6]
"""

from __future__ import annotations

import argparse
import json
import math
from collections import defaultdict

from yolo_scratch_tpu_torch.parse_trace import (
    LAYOUT,
    complete_events,
    load,
    newest_trace,
    work_items,
)
from yolo_scratch_tpu_torch.utils.profiling import trace_dir

RANGE = "train_step"
MAX_GT = 100  # the loader's ground-truth slots


def shapes_of(dims) -> list:
    """Every shape (a list of ints) in an op's ``Input Dims``, tensor lists
    included."""
    if isinstance(dims, list) and dims and all(isinstance(d, int) for d in dims):
        return [tuple(dims)]
    if isinstance(dims, list):
        return [s for d in dims for s in shapes_of(d)]
    return []


def classify(name: str, op_name: str, shapes: list, run: dict) -> str:
    """The stage of a kernel ``name`` launched by ``op_name`` on inputs of
    ``shapes`` (see the module docstring); ``run`` holds batch, imgsz, gt."""
    if LAYOUT.search(name):
        return "layout/copy"
    S, B, G = run["imgsz"], run["batch"], run["gt"]
    levels = [(S // s) ** 2 for s in (8, 16, 32)]
    anchors = {sum(levels), *levels}
    spatial = {S // 2, S // 4, S // 8, S // 16, S // 32}
    has = {d for s in shapes if len(s) in (2, 3) for d in s}
    if has & anchors:
        return "TAL (B,A,G)" if has & {G, MAX_GT} else "head/loss per-anchor"
    if any(len(s) == 4 and s[2] in spatial and s[3] in spatial for s in shapes):
        return "model spatial (fwd+bwd)"
    if any(len(s) >= 2 and s[0] == B and s[1] in (G, MAX_GT) for s in shapes):
        return "GT preprocess"
    if "conv" in op_name or "max_pool" in op_name:
        return "model spatial (fwd+bwd)"
    if shapes and max(math.prod(s) for s in shapes) <= 1 << 22:
        return "param-shaped (wgrad+opt)"
    return "other"


def launching_ops(trace: dict) -> dict:
    """External ID -> the CPU op that holds it, and correlation ID -> the
    external ID of its runtime launch event."""
    ops = {e["args"]["External id"]: e for e in complete_events(trace, "cpu_op")
           if "External id" in e.get("args", {})}
    runtime = {}
    for e in complete_events(trace, "cuda_runtime", "cuda_driver"):
        a = e.get("args", {})
        ext = a.get("External id", a.get("external id"))
        if "correlation" in a and ext is not None:
            runtime[a["correlation"]] = ext
    return {"ops": ops, "runtime": runtime}


def op_of(kernel: dict, links: dict):
    a = kernel.get("args", {})
    ext = a.get("External id", a.get("external id"))
    if ext is None or ext not in links["ops"]:
        ext = links["runtime"].get(a.get("correlation"))
    return links["ops"].get(ext)


def step_ms(trace: dict) -> float:
    """ms of the ``train_step`` ranges on the GPU's timeline (their CPU
    span where the trace has no GPU annotation)."""
    for cat in ("gpu_user_annotation", "user_annotation"):
        spans = [e["dur"] for e in complete_events(trace, cat) if e["name"] == RANGE]
        if spans:
            return sum(spans) / 1e3
    return 0.0


def stages(trace: dict) -> tuple:
    """(ms by stage, ms by stage and op, source) summed over the trace."""
    run = {"batch": 64, "imgsz": 640, "gt": 24, **trace.get("yst_run", {})}
    items, copies, source = work_items(trace)
    links = launching_ops(trace)
    stage_ms = defaultdict(float)
    stage_ops = defaultdict(lambda: defaultdict(float))
    for e, us in items:
        op = e if source == "cpu ops" else op_of(e, links)
        op_name = op["name"] if op else ""
        shapes = shapes_of(op.get("args", {}).get("Input Dims", [])) if op else []
        stage = classify(e["name"], op_name, shapes, run)
        stage_ms[stage] += us / 1e3
        label = e["name"][:60] if source == "cpu ops" else f"{op_name or '?'}: {e['name'][:60]}"
        stage_ops[stage][f"{label} {shapes[:3]}"] += us / 1e3
    for e, us in copies:
        stage_ms["copy/dma"] += us / 1e3
        stage_ops["copy/dma"][e["name"]] += us / 1e3
    return stage_ms, stage_ops, source


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="per-stage table of a train-step trace")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dir", default=str(trace_dir("yst_trace_train")))
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)

    path = newest_trace(args.dir)
    trace = load(path)
    stage_ms, stage_ops, source = stages(trace)
    it = args.iters
    whole = step_ms(trace)
    print(f"whole-step ({RANGE} ranges' span): {whole / it:8.2f} ms/iter")
    total = sum(stage_ms.values())
    order = sorted(stage_ms.items(), key=lambda kv: -kv[1])
    print(f"{'stage':28s} {'ms/iter':>9s} {'share':>7s}   ({source})")
    for k, v in order:
        print(f"{k:28s} {v / it:9.3f} {v / total * 100:6.1f}%")
    print()
    for k, _ in order:
        print(f"-- {k} (top {args.top}):")
        for opn, d in sorted(stage_ops[k].items(), key=lambda kv: -kv[1])[: args.top]:
            print(f"   {d / it:8.3f}  {opn[:100]}")
    result = dict(trace=str(path), source=source, iters=it, step_ms_per_iter=whole / it,
                  stages_ms_per_iter={k: v / it for k, v in order},
                  shares_pct={k: v / total * 100 for k, v in order},
                  device=trace.get("yst_device"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
