"""HTTP serving daemon: dynamic request batching over a Predictor (port of
``serve.py``).

Requests that arrive within a small window are coalesced into ONE
fixed-shape device batch (padded by repeating the last row, never
reshaped), run through the Predictor's device program and fanned back out
per request.

* one device-feeding worker thread, pipelined: CUDA launches return before
  the device finishes, so the worker launches a batch and decodes the next
  one while the card runs it, deferring the blocking fetch until
  ``inflight`` launches are outstanding or the queue is empty (the overlap
  discipline of ``HostPredictor.predict_paths``);
* request queue -> batch former: waits up to ``max_wait_ms`` after the first
  queued request for the batch to fill;
* stdlib only (``ThreadingHTTPServer`` + ``concurrent.futures``).

One deliberate difference from the JAX package: ``close()`` fails the
futures still queued when the worker stops (and every later ``submit``)
with an error, where the JAX server leaves them unresolved forever.

Endpoints:
  POST /v1/detect[/<name>]  body = raw image bytes (png/jpg) -> JSON
                            {"boxes": [[x1,y1,x2,y2]...] original-pixel xyxy,
                             "scores": [...], "labels": [...]}
  GET  /healthz             {"ok": true, "model": ..., "stats": {...}}

Run: ``python -m yolo_scratch_tpu_torch.serve --weights w.pt --port 8008``
(or ``--ckpt <dir> [--which best|last]``, or ``--torch-ckpt ref.pt``;
``--artifact m.pt2`` serves an exported program instead; ``--device cpu``
serves on the CPU).
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

from yolo_scratch_tpu_torch.host import PredictorConfig, detections


class ServerClosed(RuntimeError):
    """A request reached a BatchingServer after ``close()``."""


def parse_artifact_spec(spec: str):
    """Split an ``--artifact`` operand into ``(name, path)``: NAME=PATH only
    when the prefix is a bare name (a '=' inside the path, as in
    ``runs/lr=0.01/m.pt2``, is part of the path). With no name, the file
    stem is the route name."""
    name, sep, path = spec.partition("=")
    if not sep or "/" in name or "\\" in name:
        name, path = "", spec
    return name or Path(path).stem, path


class BatchingServer:
    """Coalesces concurrent detect requests into fixed-shape device batches
    over a predictor's ``_prepare``, ``predict_batch`` and ``cfg``."""

    def __init__(self, predictor, max_wait_ms: float = 5.0,
                 inflight: Optional[int] = None):
        self.predictor = predictor
        self.max_wait_s = max_wait_ms / 1e3
        # outstanding launches before the worker blocks on the oldest fetch
        self.inflight = max(1, inflight if inflight is not None
                            else getattr(predictor.cfg, "inflight", 2))
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        # counters are touched from every handler thread and the worker
        self._lock = threading.Lock()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "batch_rows": 0, "errors": 0}
        # rolling in-server latency window (enqueue -> future resolution)
        self._latencies: "deque[float]" = deque(maxlen=4096)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, image_bytes: bytes) -> Future:
        """Enqueue one image; the Future resolves to the response dict, or
        fails with ``ServerClosed`` once the server is closed."""
        fut: Future = Future()
        t0 = time.monotonic()

        def _record(f, t0=t0):
            dt = time.monotonic() - t0
            with self._lock:
                self._latencies.append(dt)
                if f.exception() is not None:
                    self.stats["errors"] += 1

        fut.add_done_callback(_record)
        with self._lock:
            self.stats["requests"] += 1
            if not self._closed:
                self._q.put((image_bytes, fut))
                return fut
        fut.set_exception(ServerClosed("the batching server is closed"))
        return fut

    def snapshot(self) -> dict:
        """Stats for /healthz: counters, batch fill rate, and p50/p99/mean
        in-server latency over the rolling window."""
        B = self.predictor.cfg.batch_size
        with self._lock:
            out = dict(self.stats)
            lat = np.asarray(self._latencies, np.float64)
        out["batch_size"] = B
        if out["batches"]:
            out["batch_fill"] = round(out["batch_rows"] / (out["batches"] * B), 4)
        if lat.size:
            out["latency_ms"] = {
                "n": int(lat.size),
                "p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
                "p99": round(float(np.percentile(lat, 99)) * 1e3, 3),
                "mean": round(float(lat.mean()) * 1e3, 3),
            }
        return out

    def close(self, timeout: float = 10.0):
        """Stop taking requests, let the worker finish what it holds, then
        fail whatever is still queued."""
        with self._lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=timeout)
        stale = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            stale.append(item[1])
        if self._worker.is_alive():  # still busy: let it see the sentinel later
            self._q.put(None)
        for fut in stale:
            if not fut.done():
                fut.set_exception(ServerClosed("the batching server closed before serving "
                                               "this request"))

    # -- device-feeding worker -------------------------------------------------

    def _form_batch(self, block: bool = True):
        """Collect up to batch_size requests. Blocks for the first only when
        ``block`` (with work in flight the worker polls, so an idle queue
        resolves outstanding batches); then waits up to max_wait_s for the
        batch to fill. None on the shutdown sentinel, [] when non-blocking
        and nothing is queued."""
        try:
            first = self._q.get(block=block)
        except queue.Empty:
            return []
        if first is None:
            return None
        entries = [first]
        B = self.predictor.cfg.batch_size
        deadline = time.monotonic() + self.max_wait_s
        while len(entries) < B:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:  # propagate shutdown after this batch
                self._q.put(None)
                break
            entries.append(nxt)
        return entries

    def _launch(self, entries):
        """Host decode + device launch of one formed batch, without a sync.
        Returns (entries, meta, device_out), or None if the whole batch
        failed already."""
        pred = self.predictor
        B = pred.cfg.batch_size
        n = len(entries)
        with self._lock:
            self.stats["batches"] += 1
            self.stats["batch_rows"] += n
        # the decode tiers read files: spool the bodies to a temporary
        # directory and reuse the batched _prepare, padded to the static shape
        with tempfile.TemporaryDirectory() as td:
            paths = []
            for i, (blob, _) in enumerate(entries):
                p = os.path.join(td, f"r{i}.bin")
                with open(p, "wb") as fh:
                    fh.write(blob)
                paths.append(p)
            try:
                imgs, meta = pred._prepare(paths + [paths[-1]] * (B - n))
            except Exception:  # noqa: BLE001
                # a poisoned request must not fail its neighbours: decode each
                # row alone, zeros (and a failed future) for the bad ones
                imgs, meta = self._prepare_rows(paths, entries)
        try:
            return entries, meta, pred.predict_batch(imgs)
        except Exception as err:  # noqa: BLE001 — launch-time failure
            for _, fut in entries:
                if not fut.done():
                    fut.set_exception(err)
            return None

    def _prepare_rows(self, paths, entries):
        pred = self.predictor
        B, S, ch = pred.cfg.batch_size, pred.cfg.img_size, pred.in_ch
        imgs = meta = None
        for i, (path, (_, fut)) in enumerate(zip(paths, entries)):
            try:
                im1, me1 = pred._prepare([path])
            except Exception as row_err:  # noqa: BLE001
                fut.set_exception(row_err)
                continue
            if imgs is None:  # the tier's dtype: uint8, or float32 / 255
                imgs = np.zeros((B, S, S, ch), im1.dtype)
                meta = np.zeros((B, 5), np.float32)
            imgs[i], meta[i] = im1[0], me1[0]
        if imgs is None:
            imgs = np.zeros((B, S, S, ch), np.uint8 if pred.cfg.u8_transfer else np.float32)
            meta = np.zeros((B, 5), np.float32)
        return imgs, meta

    def _resolve(self, launched):
        """Blocking fetch of one launched batch; fan results out."""
        entries, meta, out = launched
        try:
            packed = out.cpu().numpy()  # one blocking fetch per batch
            for j, (_, fut) in enumerate(entries):
                if not fut.done():  # done: its row failed to decode
                    fut.set_result(detections(packed[j], meta[j],
                                              self.predictor.cfg.img_size))
        except Exception as err:  # noqa: BLE001 — device failure
            for _, fut in entries:
                if not fut.done():
                    fut.set_exception(err)

    def _run(self):
        pending: "deque[tuple]" = deque()
        shutting_down = False
        while True:
            batch = [] if shutting_down else self._form_batch(block=not pending)
            if batch is None:
                shutting_down = True
                batch = []
            if batch:
                launched = self._launch(batch)
                if launched is not None:
                    pending.append(launched)
                if len(pending) < self.inflight and not shutting_down:
                    continue  # decode the next batch while this one runs
            if pending:
                self._resolve(pending.popleft())
            elif shutting_down:
                return


def make_http_server(batching, host: str = "127.0.0.1", port: int = 8008,
                     model_name: str = "yolo11", timeout_s: float = 60.0,
                     max_body_bytes: int = 32 << 20) -> ThreadingHTTPServer:
    """Wrap one BatchingServer, or a ``{name: BatchingServer}`` dict for
    multi-model serving, in a stdlib threaded HTTP server.

    ``POST /v1/detect`` goes to the first (default) model, ``POST
    /v1/detect/<name>`` to that model; each model keeps its own queue and
    worker and they share the card. ``GET /healthz`` reports per-model
    stats. ``max_body_bytes`` caps the body read: a larger POST gets 413 and
    the connection is dropped unread."""
    servers = batching if isinstance(batching, dict) else {model_name: batching}
    if not servers:
        raise ValueError("no models to serve")
    default_name = next(iter(servers))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats live in /healthz
            pass

        def _json(self, code: int, payload: dict):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True, "model": default_name, "models": sorted(servers),
                    "stats": {n: s.snapshot() for n, s in servers.items()},
                })
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path == "/v1/detect":
                target = servers[default_name]
            elif self.path.startswith("/v1/detect/"):
                name = self.path[len("/v1/detect/"):]
                if name not in servers:
                    self._json(404, {"error": f"unknown model {name!r}; have {sorted(servers)}"})
                    return
                target = servers[name]
            else:
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body; POST raw image bytes"})
                return
            if length > max_body_bytes:
                self.close_connection = True
                self._json(413, {"error": f"body {length} bytes exceeds cap {max_body_bytes}"})
                return
            blob = self.rfile.read(length)
            try:
                self._json(200, target.submit(blob).result(timeout=timeout_s))
            except FutureTimeout:
                self._json(503, {"error": f"timed out after {timeout_s}s (server overloaded?)"})
            except Exception as err:  # noqa: BLE001
                self._json(500, {"error": str(err)})

    return ThreadingHTTPServer((host, port), Handler)


def _serve(httpd: ThreadingHTTPServer, servers: dict) -> None:
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        for s in servers.values():
            s.close()


def main(argv=None, ready=None):
    """The serving CLI. ``ready`` (optional) is called with the bound HTTP
    server before it starts serving (tests and ``chip_smoke.py`` read the
    port off it and call ``shutdown()`` to stop it)."""
    import argparse

    from yolo_scratch_tpu_torch.infer import add_source_args
    from yolo_scratch_tpu_torch.models.builder import CONFIGS

    p = argparse.ArgumentParser(description="Batched detection serving daemon (PyTorch/CUDA)")
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    add_source_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", type=str, default="auto", choices=["auto", "yolo11", "yolox"])
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=8,
                   help="static device batch; requests coalesce up to this")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window after the first queued request")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--class-aware", action="store_true")
    p.add_argument("--topk", type=int, default=PredictorConfig.pre_nms_topk,
                   help="prefilter cap (pre_nms_topk); ignored with --artifact (baked in)")
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--ch", type=int, default=None)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--max-body-mb", type=int, default=32,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--int8-calib-dir", type=str, default=None, metavar="DIR",
                   help="serve int8 (nn/quant.py): calibrate activation scales on the images "
                        "under DIR, then quantize every ConvBNAct")
    p.add_argument("--artifact", action="append", default=None, metavar="[NAME=]FILE",
                   help="serve a saved export artifact (.pt2, see the export CLI) instead of a "
                        "model: no model code runs; batch, image size, channels and "
                        "thresholds come from the artifact. Repeatable: each model gets its "
                        "own queue at /v1/detect/NAME (the first is also /v1/detect)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (an artifact runs on the device it was exported on)")
    args = p.parse_args(argv)

    if args.artifact:
        if args.weights or args.ckpt or args.torch_ckpt or args.int8_calib_dir:
            raise SystemExit("--artifact is exclusive with --weights/--ckpt/--torch-ckpt/"
                             "--int8-calib-dir: the artifact already carries its weights "
                             "(export int8 with the export CLI's --int8-calib-dir)")
        from yolo_scratch_tpu_torch.export import (
            ArtifactPredictor,
            load_artifact,
            load_host_prep,
        )

        servers = {}
        for spec in args.artifact:
            name, path = parse_artifact_spec(spec)
            if name in servers:
                raise SystemExit(f"duplicate model name {name!r}")
            prep = load_host_prep(path)
            if prep is None:
                print(f"note: {path} has no .meta.json host-prep sidecar; assuming the default "
                      "letterbox prep")
            pred = ArtifactPredictor(load_artifact(path), host_prep=prep)
            servers[name] = BatchingServer(pred, max_wait_ms=args.max_wait_ms)
            print(f"model {name!r}: {path} (batch {pred.cfg.batch_size}, imgsz "
                  f"{pred.cfg.img_size}, ch {pred.in_ch}, device {pred.device}, prep "
                  f"{'letterbox' if pred.cfg.letterbox else 'stretch'})")
    else:
        from yolo_scratch_tpu_torch.infer import Predictor, load_from_args, quantize_from_paths

        model = load_from_args(args)
        cfg = PredictorConfig(img_size=args.imgsz, batch_size=args.batch,
                              conf_threshold=args.conf, iou_threshold=args.iou,
                              class_aware_nms=args.class_aware, pre_nms_topk=args.topk)
        if args.int8_calib_dir:
            exts = {".png", ".jpg", ".jpeg", ".bmp"}
            paths = sorted(str(q) for q in Path(args.int8_calib_dir).rglob("*")
                           if q.suffix.lower() in exts)
            if not paths:
                raise SystemExit(f"--int8-calib-dir: no images under {args.int8_calib_dir}")
            model = quantize_from_paths(model, cfg, paths, -(-len(paths) // args.batch),
                                        args.device)
        pred = Predictor(model, cfg, device=args.device)
        servers = {"yolo11": BatchingServer(pred, max_wait_ms=args.max_wait_ms)}
    httpd = make_http_server(servers, host=args.host, port=args.port,
                             max_body_bytes=args.max_body_mb << 20)
    print(f"serving {len(servers)} model(s) on http://{args.host}:{httpd.server_address[1]} "
          f"(window {args.max_wait_ms} ms)", flush=True)
    if ready is not None:
        ready(httpd)
    _serve(httpd, servers)
    return httpd


def cli(argv=None):
    """Console-script entry: run main() and discard its return value."""
    main(argv)


if __name__ == "__main__":
    cli()
