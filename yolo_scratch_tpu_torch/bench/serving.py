"""Load test of the batching HTTP daemon: latency and throughput under
concurrency (port of ``scripts/bench_serving.py``).

    python -m yolo_scratch_tpu_torch.bench.serving [--ckpt DIR] [--imgsz 640] [--batch 8] \
        [--clients 1,4,16] [--wait-ms 0,5,20] [--duration 15] [--out FILE]

Drives N concurrent HTTP clients against an in-process daemon (the
``serve.py`` stack: ``ThreadingHTTPServer`` + ``BatchingServer`` +
Predictor, kernel #1 in every batch, on an ephemeral port), sweeping the
client count and the batching window. Each cell gets a fresh server (clean
stats) over the same Predictor, one warm-up request, then ``--duration``
seconds of load; every thread is joined and the server shut down before the
next cell.

Per cell: ``clients``, ``wait_ms``, ``duration_s``, ``attempted``,
``completed``, ``errors`` (failed requests, of those attempted),
``achieved_img_s``, client ``latency_ms{p50,p99,mean}`` (the full HTTP
round trip), and from ``/healthz``'s stats ``batches``, ``batch_fill`` and
``server_latency_ms``. Prints one JSON line ``{"imgsz", "batch", "src_px",
"rows", "device"}``.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig, load_deploy_model
from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.serve import BatchingServer, make_http_server
from yolo_scratch_tpu_torch.utils.device import resolve_device


def encode_pngs(n: int, side: int, channels: int, seed: int = 0) -> list:
    """``n`` random PNGs, encoded once (the server's decode is part of the
    served path)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    blobs = []
    for _ in range(n):
        shape = (side, side) if channels == 1 else (side, side, 3)
        img = Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8),
                              mode="L" if channels == 1 else "RGB")
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        blobs.append(buf.getvalue())
    return blobs


def _post(url: str, blob: bytes, timeout: float) -> None:
    req = urllib.request.Request(f"{url}/v1/detect", data=blob, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        r.read()


def run_cell(predictor, blobs, n_clients: int, wait_ms: float, duration_s: float) -> dict:
    """One (clients, window) cell on a fresh BatchingServer and HTTP server."""
    batching = BatchingServer(predictor, max_wait_ms=wait_ms)
    httpd = make_http_server(batching, port=0, timeout_s=600.0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _post(url, blobs[0], 600)  # warm-up: cuDNN's algorithm search, the kernels' build
        with batching._lock:  # the stats of the timed window only
            for k in batching.stats:
                batching.stats[k] = 0
            batching._latencies.clear()

        stop = threading.Event()
        lat = [[] for _ in range(n_clients)]
        attempted, errors = [0] * n_clients, [0] * n_clients

        def client(ci: int):
            k = ci  # stagger the blob cycle so clients do not sync on one image
            while not stop.is_set():
                blob = blobs[k % len(blobs)]
                k += n_clients
                attempted[ci] += 1
                t0 = time.perf_counter()
                try:
                    _post(url, blob, 300)
                    lat[ci].append(time.perf_counter() - t0)
                except (OSError, http.client.HTTPException):  # count it, keep going
                    errors[ci] += 1

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(duration_s)
        stop.set()
        for t in threads:
            t.join(timeout=330)
        wall = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client thread did not finish")
        stats = batching.snapshot()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        batching.close()

    lat = np.asarray([x for per in lat for x in per], np.float64)
    done = int(lat.size)

    def pct(q):
        return round(float(np.percentile(lat, q)) * 1e3, 2) if done else None

    return {
        "clients": n_clients, "wait_ms": wait_ms, "duration_s": round(wall, 2),
        "attempted": int(sum(attempted)), "completed": done, "errors": int(sum(errors)),
        "achieved_img_s": round(done / wall, 2),
        "latency_ms": {"p50": pct(50), "p99": pct(99),
                       "mean": round(float(lat.mean()) * 1e3, 2) if done else None},
        "batches": stats["batches"], "batch_fill": stats.get("batch_fill"),
        "server_latency_ms": stats.get("latency_ms"),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Serving daemon load test "
                                            "(scripts/bench_serving.py)")
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--scale", type=str, default="n")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir of the port's trainer; default: seeded init (the "
                        "weights do not change the serving cost)")
    p.add_argument("--which", type=str, default="best", choices=["best", "last"])
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--ch", type=int, default=None)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--src-px", type=int, default=1024,
                   help="client image side before the server's letterbox")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--clients", type=str, default="1,4,16")
    p.add_argument("--wait-ms", type=str, default="0,5,20")
    p.add_argument("--duration", type=float, default=15.0)
    p.add_argument("--n-images", type=int, default=8)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    model = load_deploy_model(args.cfg, scale=args.scale, ch=args.ch, nc=args.nc,
                              ckpt=args.ckpt, which=args.which, device=dev)
    pred = Predictor(model, PredictorConfig(img_size=args.imgsz, batch_size=args.batch,
                                            conf_threshold=0.25), device=dev)
    blobs = encode_pngs(args.n_images, args.src_px, pred.in_ch)
    rows = []
    with C.kernel1_launches() as k1:
        for wait_ms in [float(x) for x in args.wait_ms.split(",")]:
            for n_clients in [int(x) for x in args.clients.split(",")]:
                rows.append(run_cell(pred, blobs, n_clients, wait_ms, args.duration))
    result = {"imgsz": args.imgsz, "batch": args.batch, "src_px": args.src_px, "rows": rows,
              "payload_kib": round(len(blobs[0]) / 1024, 1), "nms_launches": k1["launches"],
              "device": C.device_block(dev)}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return C.emit(result)


if __name__ == "__main__":
    main()
