"""Profiling hooks (port of ``utils/profiling.py``).

``trace(logdir)`` records a region with ``torch.profiler`` (the CPU, and
the card where there is one) and writes the trace into ``logdir`` in
TensorBoard's profiler format (``*.pt.trace.json``, also readable by
Perfetto); ``annotate(name)`` marks a sub-region
(``torch.profiler.record_function``); ``time_fn`` gives the wall time of a
call after warm-up, synchronised: CUDA events where the output lies on a
card, ``time.perf_counter`` on the CPU. ``trace_dir`` and ``export_trace`` are the
profilers' (``profile_forward``, ``profile_train``): a Chrome trace with
what it ran and where, which ``parse_trace`` and ``train_roofline`` read.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Tuple

import torch

from yolo_scratch_tpu_torch.utils.guards import tensor_leaves


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def trace_dir(name: str) -> Path:
    """The profilers' default trace directory, ``name`` under the temporary
    directory (``/tmp/yst_trace`` and ``/tmp/yst_trace_train``, as the JAX
    scripts write, where ``TMPDIR`` is unset)."""
    return Path(tempfile.gettempdir()) / name


def export_trace(prof, out_dir: str | os.PathLike, tag: str, **metadata) -> Path:
    """Write ``prof``'s Chrome trace as ``out_dir/<tag>_<time>.pt.trace.json``
    with each ``metadata`` item as a top-level JSON key (the device block,
    the run's shapes). Call it inside the ``profile`` block: the profiler
    takes metadata only while it is open; the file is written as it closes."""
    for key, value in metadata.items():
        prof.add_metadata_json(key, json.dumps(value))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{time.time_ns() % 10**9:09d}"
    path = out / f"{tag}_{stamp}.pt.trace.json"
    prof.on_trace_ready = lambda p: p.export_chrome_trace(str(path))
    return path


def annotate(name: str):
    """Named sub-region inside a trace (a context manager)."""
    return torch.profiler.record_function(name)


def _cuda_device(out: Any):
    return next((t.device for t in tensor_leaves(out) if t.is_cuda), None)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> Tuple[float, Any]:
    """Returns (seconds_per_call, last_output): ``warmup`` calls, then
    ``iters`` back to back, timed between CUDA events on the output's card
    (the device's time where it is the bottleneck, the host's launch time
    where it is not), else by ``time.perf_counter``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = _cuda_device(out)
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        return (time.perf_counter() - t0) / iters, out
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters, out
