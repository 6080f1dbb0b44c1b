"""Profiling hooks (port of ``utils/profiling.py``).

``trace(logdir)`` records a region with ``torch.profiler`` (the CPU, and
the card where there is one) and writes the trace into ``logdir`` in
TensorBoard's profiler format (``*.pt.trace.json``, also readable by
Perfetto); ``annotate(name)`` marks a sub-region
(``torch.profiler.record_function``); ``time_fn`` gives the wall time of a
call after warm-up, synchronised: CUDA events where the output lies on a
card, ``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import contextlib
import time
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
