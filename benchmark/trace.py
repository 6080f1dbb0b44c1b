"""The device trace of a traced window, read from ``torch.profiler``'s
Chrome trace.

The window runs inside ``torch.profiler.profile`` (CPU and CUDA
activities) and a ``record_function`` span ``bench.window``; the benchmark's
own spans around the calls into the program (``bench.forward``,
``bench.postprocess``) sit inside it. The trace is
written to ``$TMPDIR``, read and deleted. From it:

* device intervals: every kernel, copy and memset on the card;
* ``busy_s``: the union of those intervals inside the window;
* a span's device time: the kernels whose launch (the runtime call, by
  correlation id) lies inside one of the span's host intervals;
* idle gaps: the stretches of the window with nothing on the device, each
  named by the innermost host op running as it began;
* the top device ops by time.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """The parsed trace of one window."""

    def __init__(self, events: List[dict]):
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
        self.launch_ts: Dict[int, float] = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch_ts[corr] = e["ts"]
        win = self.spans("bench.window")
        if not win:
            raise RuntimeError("the trace holds no bench.window span")
        self.t0, self.t1 = win[0][0], win[-1][1]

    def spans(self, name: str) -> List[Tuple[float, float]]:
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in self.host
                      if e.get("cat") == "user_annotation" and e["name"] == name)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _intervals(self) -> List[Tuple[float, float]]:
        out = []
        for e in self.device:
            a, b = max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)
            if b > a:
                out.append((a, b))
        out.sort()
        merged: List[List[float]] = []
        for a, b in out:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) / 1e6

    def kernels_under(self, span: str) -> float:
        """Seconds of the kernels launched inside ``span``'s host intervals."""
        iv = self.spans(span)
        starts = [a for a, _ in iv]
        total = 0.0
        for e in self.device:
            if e["cat"] != "kernel":
                continue
            ts = self.launch_ts.get(e.get("args", {}).get("correlation"))
            i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
            if i >= 0 and ts <= iv[i][1]:
                total += e["dur"]
        return total / 1e6

    def copies_s(self, kind: str = "HtoD") -> float:
        """Seconds of device copies of ``kind`` inside the window."""
        return sum(e["dur"] for e in self.device if e["cat"] == "gpu_memcpy"
                   and kind in e["name"] and self.t0 <= e["ts"] <= self.t1) / 1e6

    def kernel_s(self, names: Tuple[str, ...]) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds one of ``names``."""
        hits = [e for e in self.device if e["cat"] == "kernel"
                and any(n in e["name"] for n in names) and self.t0 <= e["ts"] <= self.t1]
        return sum(e["dur"] for e in hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for e in self.device:
            if self.t0 <= e["ts"] <= self.t1:
                by[e["name"][:90]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The window's idle stretches summed by the innermost host op
        running as each began (``host idle`` where none ran)."""
        iv = self._intervals()
        edges = [(self.t0, iv[0][0] if iv else self.t1)]
        edges += [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]
        if iv:
            edges.append((iv[-1][1], self.t1))
        host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.host
                       if e["name"] != "bench.window"), key=lambda h: h[0])
        by = defaultdict(float)
        j = 0
        active: List[Tuple[float, float, str]] = []
        for a, b in sorted(edges):
            if b <= a:
                continue
            while j < len(host) and host[j][0] <= a:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[1] > a]
            name = min(active, key=lambda h: h[1] - h[0])[2] if active else "host idle"
            by[name[:90]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def traced() -> Iterator[Dict[str, Trace]]:
    """Profile the block; on exit ``out["trace"]`` holds its :class:`Trace`.
    The block marks its window with ``record_function("bench.window")``."""
    from torch.profiler import ProfilerActivity, profile

    out: Dict[str, Trace] = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            out["trace"] = Trace(json.load(fh)["traceEvents"])
    finally:
        os.unlink(path)
