"""Device times on the card, for ``chip_smoke.py`` and the probes.

``call_ms``, ``device_profile`` and ``device_ms`` read a ``torch.profiler``
trace: the sum of device time the trace records, so the wrapper's host work
is not in them (a short launch ends before the next call has been enqueued,
and CUDA events around the calls would time the host). ``call_ms`` sums the kernels one
call launches (one for the bottleneck; the NMS sweep's mask and reduce)
and gives each one's time. ``time_ms`` uses CUDA events around
back-to-back calls: device time where the device is the bottleneck, the
host's launch time where it is not.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

from yolo_scratch_tpu_torch.utils.profiling import SPAN_PREFIX


# A process that opens many profiler sessions back to back now and then gets
# one whose trace lost its device events; a fresh session is clean again.
SESSIONS = 3


def _trace(fn: Callable[[], object], reps: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key
            and not e.key.startswith(SPAN_PREFIX)]


def call_ms(fn: Callable[[], object], kernels: tuple[str, ...],
            reps: int = 50) -> tuple[float, dict[str, float]]:
    """Device time of one call of ``fn`` that launches each kernel of
    ``kernels`` (symbol substrings) once: their times summed, and each
    kernel's own, over ``reps`` calls. Each kernel must be seen about
    ``reps`` times (at most ``reps``; the trace may drop a few events), and
    each is averaged over the launches the trace holds, so a dropped event
    does not read as a shorter call. A trace that falls short is taken
    again, up to ``SESSIONS`` times."""
    for _ in range(SESSIONS):
        rows = _trace(fn, reps)
        hits = {k: [e for e in rows if k in e.key] for k in kernels}
        seen = {k: sum(e.count for e in h) for k, h in hits.items()}
        if all(reps // 2 <= s <= reps for s in seen.values()):
            split = {k: sum(e.self_device_time_total for e in h) / seen[k] / 1e3
                     for k, h in hits.items()}
            return sum(split.values()), split
    raise AssertionError(f"profiler saw {seen} launches in {reps} calls")


def device_profile(fn: Callable[[], object], reps: int = 20, top: int = 8) -> dict:
    """The device work of one call of ``fn``, averaged over ``reps`` calls:
    ``ms``, the time of all its kernels and copies summed (gaps between them
    are not counted); ``ops``, their number; ``top``, the ``top`` longest
    as (name, ms, count). A trace with no device work is taken again, up to
    ``SESSIONS`` times."""
    for _ in range(SESSIONS):
        rows = _trace(fn, reps)
        if rows:
            rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
            return dict(ms=sum(e.self_device_time_total for e in rows) / reps / 1e3,
                        ops=sum(e.count for e in rows) // reps,
                        top=[(e.key[:70], e.self_device_time_total / reps / 1e3,
                              e.count // reps) for e in rows[:top]])
    raise AssertionError("profiler saw no device work")


def device_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """The ``ms`` of :func:`device_profile`."""
    return device_profile(fn, reps)["ms"]


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


def ranges_ms(fns: dict[str, Callable[[], object]], reps: int = 5) -> dict[str, float]:
    """Device ms of one call of each ``fns[name]``, all in ONE profiler
    session: each name's ``reps`` calls run inside a ``record_function``
    range of that name, whose device time sums the kernels launched under
    it. For comparing many small programs without a session each (the
    profiler drops events across many sessions). A range with no device
    time raises."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in fns.items():
            with record_function(name):
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
    out = dict.fromkeys(fns, 0.0)
    for e in prof.events():
        if e.name in out:
            out[e.name] += e.device_time_total
    empty = [n for n, v in out.items() if v <= 0]
    if empty:
        raise AssertionError(f"profiler saw no device time under {empty}")
    return {n: v / reps / 1e3 for n, v in out.items()}
