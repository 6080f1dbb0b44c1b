"""Structured training observability (a copy of the JAX package's
``utils/logging.py``, which imports no JAX).

Per-step or per-epoch scalar records (loss triplet, lr, img/s) go through a
pluggable writer stack: a stdout table, a JSONL file, or any callable. A
throughput meter keeps images/s per device over a sliding window.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional


class JsonlWriter:
    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def __call__(self, record: Dict):
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


class StdoutWriter:
    """Reference-style compact line (``train_yolo11_cuda.py:79-84``)."""

    def __init__(self, every: int = 50):
        self.every = every

    def __call__(self, record: Dict):
        step = record.get("step", 0)
        if step % self.every:
            return
        parts = [f"step {step}"]
        for k, v in record.items():
            if k == "step":
                continue
            parts.append(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}")
        print(" | ".join(parts))


class MetricsLogger:
    def __init__(self, writers: Optional[List[Callable[[Dict], None]]] = None):
        self.writers = writers if writers is not None else [StdoutWriter()]

    def log(self, step: int, **scalars):
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        for w in self.writers:
            w(record)


class ThroughputMeter:
    """images/s per device over a sliding window."""

    def __init__(self, n_chips: int = 1, window: int = 50):
        self.n_chips = max(n_chips, 1)
        self.window = window
        self._events: List[tuple] = []

    def update(self, n_images: int):
        now = time.perf_counter()
        self._events.append((now, n_images))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def images_per_sec_per_chip(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        imgs = sum(n for _, n in self._events[1:])
        return imgs / dt / self.n_chips if dt > 0 else 0.0
