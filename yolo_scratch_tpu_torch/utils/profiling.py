"""Profiling hooks (port of ``utils/profiling.py``).

``trace(logdir)`` records a region with ``torch.profiler`` (the CPU, and
the card where there is one) and writes the trace into ``logdir`` in
TensorBoard's profiler format (``*.pt.trace.json``, also readable by
Perfetto); ``annotate(name)`` marks a sub-region
(``torch.profiler.record_function``) while a profiler records, and is a
shared null context otherwise; ``time_fn`` gives the wall time of a
call after warm-up, synchronised: CUDA events where the output lies on a
card, ``time.perf_counter`` on the CPU. ``trace_dir`` and ``export_trace`` are the
profilers' (``profile_forward``, ``profile_train``): a Chrome trace with
what it ran and where, which ``parse_trace`` and ``train_roofline`` read.

The program's spans, each with the benchmark's metric that reads it
(``benchmark/metrics/<metric>.py``). A span wraps exactly the code that
launches its layer's kernels, so a trace reader attributes every kernel (by
its launch, correlation id to runtime call) to one span:

* ``yst.h2d``: ``Predictor._forward``'s way to the card: for a host batch on
  a CUDA Predictor the host copy into a pinned buffer and the enqueue of
  its copy on the side stream (``infer.py::PinnedRing``), else the plain
  ``.to(device)``; ``h2d_host_ms.deploy``;
* ``yst.normalize``: its cast and /255; ``normalize_ms.deploy``;
* ``yst.model``: the network; ``model_ms.deploy``;
* ``yst.select``: candidate selection and decode (``ops/decode.py``; YOLOX's
  ``yolox_eval_decode`` in ``Predictor``); ``select_ms.deploy``;
* ``yst.nms``: kernel #1 or #2, the class offset and the ``max_det`` cap
  (``ops/decode.py``); ``nms_ms.deploy``;
* ``yst.pack``: the gather and normalisation (``ops/decode.py::_finish``) and
  ``Predictor``'s ``pack_detections``; ``pack_ms.deploy``;
* ``yst.count``: the NMS counter's kernels, after ``yst.nms``; read by no
  metric, so that no layer's time holds them;
* ``yst.train.<phase>`` (``TrainStep._phase``) for ``h2d``, ``augment``,
  ``forward``, ``loss``, ``backward``, ``all_reduce`` and ``clip_adamw_ema``:
  ``forward_kernel_ms.train``, ``loss_kernel_ms.train``,
  ``backward_kernel_ms.train``, ``update_kernel_ms.train`` (of
  ``clip_adamw_ema``); the ``yst.train.h2d`` intervals count the steps.

The program's counters (:func:`count`, read by :func:`counters` once after
a traced window; ``nms_needed_pct.deploy`` reads the first two,
``h2d_staged_pct.deploy`` and ``h2d_slot_wait_pct.deploy`` the last two):

* ``nms.pairs_needed``: the IoU tests greedy NMS needs, each kept pivot
  (the sweep's keep before the ``max_det`` cap) against every valid box
  after it, summed over the images the kernel path swept (``ops/decode.py``);
* ``nms.pairs_swept``: the pairs the sweeps test, N(N-1)/2 an image, from
  the launch geometry (``ops/nms_kernels.py``);
* ``h2d.staged``: the batches ``PinnedRing`` staged (``infer.py``), one a
  host batch on a CUDA Predictor;
* ``h2d.slot_waits``: the times a staged batch found its pinned slot's
  previous copy still running, and waited for it on the host.

With no profiler recording, ``annotate`` and ``enabled`` are one flag test
each and reach no dispatcher; callers guard a counter's computation with
``if enabled():`` so that nothing is launched for it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

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


#: the prefix of every span the program records; a profiler's table shows a
#: span as a row of its own (on the card's timeline too): not a kernel
SPAN_PREFIX = "yst."
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a profiler records (and nothing compiles): the one test that
    gates every span and counter."""
    return _autograd_profiler._is_profiler_enabled and not torch.compiler.is_compiling()


def annotate(name: str):
    """Named sub-region inside a trace (a context manager): a
    ``record_function`` while a profiler records, else one shared null
    context."""
    return torch.profiler.record_function(name) if enabled() else _NULL


_host_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}
_counts_lock = threading.Lock()  # a daemon's worker threads may count at once


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d integer tensor on any device) to the
    counter ``name``, while a profiler records; nothing otherwise. A
    tensor's total stays on its device, read by :func:`counters`."""
    if not enabled():
        return
    with _counts_lock:
        if isinstance(value, torch.Tensor):
            v = value.detach().to(torch.int64)
            acc = _device_counts.get(name)
            _device_counts[name] = v.clone() if acc is None else acc + v.to(acc.device)
        else:
            _host_counts[name] = _host_counts.get(name, 0) + int(value)


def counters() -> Dict[str, int]:
    """Every counter's total: ``{name: int}``, after one sync per device."""
    with _counts_lock:
        out = dict(_host_counts)
        device = dict(_device_counts)
    by_device: Dict[torch.device, list] = {}
    for name, t in device.items():
        by_device.setdefault(t.device, []).append(name)
    for names in by_device.values():
        for name, v in zip(names, torch.stack([device[n] for n in names]).tolist()):
            out[name] = out.get(name, 0) + int(v)
    return out


def reset_counters() -> None:
    with _counts_lock:
        _host_counts.clear()
        _device_counts.clear()


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
