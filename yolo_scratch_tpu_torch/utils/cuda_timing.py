"""Device times on the card, for ``chip_smoke.py`` and the probes.

``kernel_ms`` and ``device_ms`` read a ``torch.profiler`` trace: the sum of
device time the trace records, so the wrapper's host work is not in them (a
short launch ends before the next call has been enqueued, and CUDA events
around the calls would time the host). ``time_ms`` uses CUDA events around
back-to-back calls: device time where the device is the bottleneck, the
host's launch time where it is not.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def _trace(fn: Callable[[], object], reps: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn: Callable[[], object], kernel: str, reps: int = 50) -> float:
    """Mean device time of one launch of the CUDA kernel whose symbol holds
    ``kernel``, over ``reps`` calls of ``fn``."""
    rows = [e for e in _trace(fn, reps) if kernel in e.key]
    # the trace may drop an event or two of a window; average what it holds
    seen = sum(e.count for e in rows)
    if seen < reps // 2:
        raise AssertionError(f"profiler saw {seen} of {reps} launches of {kernel}")
    return sum(e.self_device_time_total for e in rows) / seen / 1e3


def device_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Device time of all kernels and copies of one call of ``fn``, summed
    (gaps between them are not counted), averaged over ``reps`` calls."""
    rows = _trace(fn, reps)
    if not rows:
        raise AssertionError("profiler saw no device work")
    return sum(e.self_device_time_total for e in rows) / reps / 1e3


def time_ms(fn: Callable[[], object], reps: int, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)
