"""Re-aggregate a ``torch.profiler`` Chrome trace: device compute only
(port of ``scripts/parse_trace.py``, with its flags). Pure parsing: it
imports no model code and needs no card.

Reads the newest ``*.pt.trace.json`` under ``--dir`` (``profile_forward``'s
default directory). Only GPU kernel events (``"cat": "kernel"``) count as
compute. Memcpy and memset events overlap compute on their own engines, so
they form the ``copy/dma`` bucket (the JAX script's ``async-dma``) and stay
out of the compute sums; ``--asyncs`` lists them. A kernel's category is its
base name, with the return type, namespaces, template and launch arguments
stripped; layout kernels (NCHW<->NHWC conversions, copies, ``contiguous``)
go to ``layout-copy``. Prints the categories and the top ``--top`` kernels
in ms per iteration (``--iters`` of them in the trace), then a JSON line
with the totals and the trace's ``device`` block.

A trace with no device events (a ``--device cpu`` trace) is read through
its CPU ops' self times instead (each op's time less its child ops'), so
that the whole chain runs on the CPU too; those numbers are host times, not
device times.

    python -m yolo_scratch_tpu_torch.parse_trace [--top 40] [--iters 5] [--dir DIR] [--asyncs]
"""

from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from pathlib import Path

from yolo_scratch_tpu_torch.utils.profiling import trace_dir

COPY_CATS = ("gpu_memcpy", "gpu_memset")
# kernels (and, in a CPU trace, ops) that only move data between layouts, by
# full name: PyTorch's copy kernels show the copy functor only among their
# template arguments
LAYOUT = re.compile(r"nchwToNhwc|nhwcToNchw|[Tt]ranspose|copy|[Cc]ontiguous"
                    r"|^aten::(clone|permute|to)$")


def newest_trace(directory) -> Path:
    """The most recently written ``*.pt.trace.json`` under ``directory``."""
    paths = sorted(Path(directory).rglob("*.pt.trace.json"), key=lambda p: (p.stat().st_mtime,
                                                                               str(p)))
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {directory}")
    return paths[-1]


def load(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def complete_events(trace: dict, *cats: str) -> list:
    """The trace's complete (``"ph": "X"``) events of the categories ``cats``."""
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and e.get("cat") in cats]


def cpu_self_times(trace: dict) -> list:
    """``(event, self us)`` of every CPU op: its duration less those of the
    ops directly inside it on the same thread."""
    ops = sorted(complete_events(trace, "cpu_op"),
                 key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"]))
    out, stack = [], []  # stack of [event, self us, end]
    for e in ops:
        while stack and (stack[-1][0]["pid"], stack[-1][0]["tid"]) != (e["pid"], e["tid"]):
            out.append(tuple(stack.pop()[:2]))
        while stack and e["ts"] >= stack[-1][2]:
            out.append(tuple(stack.pop()[:2]))
        if stack:
            stack[-1][1] -= e["dur"]
        stack.append([e, float(e["dur"]), e["ts"] + e["dur"]])
    out.extend(tuple(s[:2]) for s in reversed(stack))
    return out


def work_items(trace: dict) -> tuple:
    """``(items, copies, source)``: ``(event, us)`` of each kernel and of each
    memcpy/memset, ``source`` "device kernels"; or, in a trace with neither,
    each CPU op and its self time, no copies, ``source`` "cpu ops"."""
    kernels = complete_events(trace, "kernel")
    copies = complete_events(trace, *COPY_CATS)
    if kernels or copies:
        return ([(e, float(e["dur"])) for e in kernels],
                [(e, float(e["dur"])) for e in copies], "device kernels")
    return cpu_self_times(trace), [], "cpu ops"


def base_name(name: str) -> str:
    """``void at::native::elementwise_kernel<128, 4, F>(int, F)`` ->
    ``elementwise_kernel``: no return type, arguments, templates or
    namespaces."""
    s = re.sub(r"^void\s+", "", name.strip())
    depth, kept = 0, []
    for c in s:  # drop <...> and (...) at any depth
        if c in "<(":
            depth += 1
        elif c in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            kept.append(c)
    s = "".join(kept).strip()
    return s.split("::")[-1].strip() or name


def category(name: str) -> str:
    return "layout-copy" if LAYOUT.search(name) else base_name(name)


def summarise(trace: dict, iters: int) -> dict:
    """Categories, ops and copies in ms per iteration, and the totals."""
    items, copies, source = work_items(trace)
    cats, ops, asyncs = defaultdict(float), defaultdict(float), defaultdict(float)
    for e, us in items:
        cats[category(e["name"])] += us / 1e3
        ops[e["name"]] += us / 1e3
    for e, us in copies:
        asyncs[e["name"]] += us / 1e3
    total, copy_ms = sum(ops.values()), sum(asyncs.values())
    return dict(source=source, iters=iters, events=len(items), total_ms=total,
                ms_per_iter=total / iters, copy_events=len(copies), copy_ms=copy_ms,
                categories=per_iter(cats, iters), ops=per_iter(ops, iters),
                asyncs=per_iter(asyncs, iters))


def per_iter(ms: dict, iters: int) -> dict:
    """``ms`` divided by ``iters``, largest first."""
    return {k: v / iters for k, v in sorted(ms.items(), key=lambda kv: -kv[1])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="device compute of a torch.profiler trace")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dir", default=str(trace_dir("yst_trace")))
    ap.add_argument("--asyncs", action="store_true", help="also list top copy/DMA events")
    args = ap.parse_args(argv)

    path = newest_trace(args.dir)
    trace = load(path)
    s = summarise(trace, args.iters)
    if args.asyncs:
        print("== top copy/dma events (ms/iter; on their own engines, overlapping) ==")
        for name, ms in list(s["asyncs"].items())[: args.top]:
            print(f"{ms:9.3f}  {name[:110]}")
    print(f"== categories (ms/iter; {s['source']}) ==")
    for k, v in list(s["categories"].items())[:20]:
        print(f"{v:9.3f}  {k}")
    if s["copy_events"]:
        print(f"{s['copy_ms'] / args.iters:9.3f}  copy/dma (not in the compute total)")
    print("== top compute ops (ms/iter) ==")
    for name, ms in list(s["ops"].items())[: args.top]:
        print(f"{ms:9.3f}  {name[:110]}")
    result = dict(trace=str(path), source=s["source"], iters=args.iters, events=s["events"],
                  total_ms=s["total_ms"], ms_per_iter=s["ms_per_iter"],
                  copy_events=s["copy_events"], copy_ms_per_iter=s["copy_ms"] / args.iters,
                  categories=dict(list(s["categories"].items())[:20]),
                  device=trace.get("yst_device"))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
