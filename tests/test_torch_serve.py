"""The port's serving daemon (``serve.py``), the analog of
``tests/test_serve.py``, end to end over HTTP on the CPU.

Every response must equal the port's ``predict_paths`` on the same image
exactly (the daemon runs the Predictor's own program on padded batches).
One f32 response is held to the JAX daemon's on the same weights: the same
JSON keys, labels exact, scores within 1e-5 and pixel boxes within 1e-5 of
the unmap scale (tests/test_torch_infer.py's Predictor tolerances). A
future queued behind ``close()`` fails instead of hanging: the port's one
deliberate difference from the JAX daemon.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_infer import _seeded_model
from tests.test_torch_train_step import one_torch_thread  # noqa: F401 (autouse fixture)
from yolo_scratch_tpu_torch import serve
from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig
from yolo_scratch_tpu_torch.serve import BatchingServer, ServerClosed, make_http_server

IMG = 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png_bytes(rng, w=100, h=80):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8), mode="L").save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def served():
    pred = Predictor(_seeded_model(), PredictorConfig(img_size=IMG, batch_size=4,
                                                      conf_threshold=0.25), device="cpu")
    batching = BatchingServer(pred, max_wait_ms=150.0)
    httpd = make_http_server(batching, port=0)  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", batching, pred
    httpd.shutdown()
    httpd.server_close()
    batching.close()
    t.join(timeout=10)


def _post(url, body, timeout=300):
    req = urllib.request.Request(f"{url}/v1/detect", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _reference(pred, bodies, tmp_path):
    """predict_paths on the same bytes, written to files."""
    paths = []
    for i, b in enumerate(bodies):
        p = tmp_path / f"req{i}.png"
        p.write_bytes(b)
        paths.append(str(p))
    return [{k: r[k] for k in ("boxes", "scores", "labels")} for r in pred.predict_paths(paths)]


def test_healthz(served):
    url, _, _ = served
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body["ok"] is True and "stats" in body and body["models"] == ["yolo11"]


def test_detect_roundtrip_equals_predict_paths(served, tmp_path):
    url, _, pred = served
    body = _png_bytes(np.random.RandomState(0))
    got = _post(url, body)
    assert set(got) == {"boxes", "scores", "labels"}
    assert got == _reference(pred, [body], tmp_path)[0]
    assert got["scores"]
    for x1, y1, x2, y2 in got["boxes"]:  # original-image pixels (100x80 input)
        assert 0 <= x1 <= x2 <= 100 and 0 <= y1 <= y2 <= 80


def test_concurrent_requests_coalesce(served, tmp_path):
    """Requests issued together land in fewer device batches than requests,
    and each answer equals predict_paths on its own image."""
    url, batching, pred = served
    rng = np.random.RandomState(1)
    payloads = [_png_bytes(rng, w=60 + 13 * i, h=90 - 7 * i) for i in range(6)]
    results = [None] * 6

    def post(i):
        results[i] = _post(url, payloads[i])

    b0 = batching.stats["batches"]
    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert batching.stats["batches"] - b0 < 6  # coalesced (batch size 4)
    assert results == _reference(pred, payloads, tmp_path)


def test_bad_requests(served):
    url, _, _ = served
    req = urllib.request.Request(f"{url}/v1/detect", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nope", timeout=30)
    assert e.value.code == 404
    # garbage bytes -> 500 with an error message, the server stays up
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, b"not an image")
    assert e.value.code == 500
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"] is True


def test_poisoned_request_does_not_fail_neighbors(served, tmp_path):
    """A garbage payload coalesced with good ones fails alone, and the good
    ones still get predict_paths' answers."""
    url, _, pred = served
    rng = np.random.RandomState(2)
    payloads = [_png_bytes(rng), b"this is not an image", _png_bytes(rng, w=70, h=120)]
    out = [None] * 3

    def post(i):
        try:
            out[i] = (200, _post(url, payloads[i]))
        except urllib.error.HTTPError as e:
            out[i] = (e.code, None)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert [c for c, _ in out] == [200, 500, 200]
    ref = _reference(pred, [payloads[0], payloads[2]], tmp_path)
    assert [out[0][1], out[2][1]] == ref


def test_oversized_body_rejected(served):
    """A Content-Length above the cap gets 413 without the body being read;
    the server stays up."""
    import http.client
    import urllib.parse

    url, _, _ = served
    conn = http.client.HTTPConnection(urllib.parse.urlparse(url).netloc, timeout=30)
    try:
        conn.putrequest("POST", "/v1/detect")
        conn.putheader("Content-Length", str(10 << 30))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "cap" in json.loads(resp.read())["error"]
    finally:
        conn.close()
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"] is True


def test_healthz_latency_and_fill_stats(served):
    url, _, _ = served
    _post(url, _png_bytes(np.random.RandomState(4)))
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        body = json.loads(r.read())
    stats = body["stats"][body["model"]]
    assert stats["requests"] >= 1 and stats["batches"] >= 1
    assert 0.0 < stats["batch_fill"] <= 1.0
    lat = stats["latency_ms"]
    assert lat["n"] >= 1 and 0 < lat["p50"] <= lat["p99"]


def test_f32_response_matches_the_jax_daemon():
    """One request through the port's daemon and through the JAX daemon on
    the same f32 weights: the same keys; labels exact, scores within 1e-5,
    pixel boxes within 1e-5 of the unmap scale."""
    from yolo_scratch_tpu.infer import Predictor as JaxPredictor
    from yolo_scratch_tpu.infer import PredictorConfig as JaxConfig
    from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
    from yolo_scratch_tpu.serve import BatchingServer as JaxBatchingServer
    from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
    from tests.test_torch_infer import JAX_CFG

    tm = _seeded_model()
    params, stats = convert_reference_state_dict(tm.state_dict())
    kw = dict(img_size=IMG, batch_size=2, conf_threshold=0.25, bf16=False)
    jp = JaxPredictor(jax_build(JAX_CFG, ch=1, nc=5, scale="n"),
                      {"params": params, "batch_stats": stats}, JaxConfig(**kw, nms_impl="xla"))
    tp = Predictor(tm, PredictorConfig(**kw), device="cpu")
    body = _png_bytes(np.random.RandomState(6), w=120, h=70)
    servers = [JaxBatchingServer(jp, max_wait_ms=1.0), BatchingServer(tp, max_wait_ms=1.0)]
    try:
        ref, got = (s.submit(body).result(timeout=600) for s in servers)
    finally:
        for s in servers:
            s.close()
    assert set(got) == set(ref) == {"boxes", "scores", "labels"}
    assert got["labels"] == ref["labels"] and len(got["labels"]) > 0
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=1e-5 * IMG * 2)


# ------------------------------------------------- pipelining and shutdown

class _LazyOut:
    """An asynchronous device result: ready ``d_dev`` after its launch; the
    fetch (``.cpu()``) blocks until then."""

    def __init__(self, d_dev, B):
        self.ready_at = time.monotonic() + d_dev
        self.B = B

    def cpu(self):
        wait = self.ready_at - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        return torch.zeros((self.B, 4, 7))


class _FakePredictor:
    """Host decode takes ``d_host`` (sleep; or waits on ``gate``), the device
    ``d_dev`` (_LazyOut)."""

    def __init__(self, d_host, d_dev, inflight, gate=None):
        self.d_host, self.d_dev, self.gate = d_host, d_dev, gate
        self.cfg = PredictorConfig(img_size=8, batch_size=2, u8_transfer=False,
                                   inflight=inflight)
        self.in_ch = 1

    def _prepare(self, paths):
        if self.gate is not None:
            self.gate.wait(timeout=30)
        time.sleep(self.d_host)
        n = len(paths)
        return np.zeros((n, 8, 8, 1), np.float32), np.zeros((n, 5), np.float32)

    def predict_batch(self, imgs):
        return _LazyOut(self.d_dev, imgs.shape[0])


def _drive(inflight, n_req=8, d=0.03):
    srv = BatchingServer(_FakePredictor(d, d, inflight), max_wait_ms=50.0, inflight=inflight)
    t0 = time.monotonic()
    futs = [srv.submit(b"x") for _ in range(n_req)]
    for f in futs:
        assert f.result(timeout=30) == {"boxes": [], "scores": [], "labels": []}
    dt = time.monotonic() - t0
    srv.close()
    return dt


def test_worker_pipelines_decode_with_device():
    """With inflight > 1 the worker decodes batch N+1 while batch N runs on
    the 'device': 4 batches of 30 ms decode + 30 ms device finish clearly
    faster than the serialized inflight=1 loop (~240 ms against ~150 ms
    ideal; the JAX test's 1.2x margin)."""
    t_serial = _drive(inflight=1)
    t_pipe = _drive(inflight=3)
    assert t_serial > 1.2 * t_pipe, (t_serial, t_pipe)


def test_close_serves_what_it_holds_and_fails_what_comes_after():
    """Requests queued before close() are served; a request after it fails
    at once with ServerClosed (the JAX daemon leaves it pending forever);
    a request still queued when a stuck worker outlives close()'s wait
    fails too, and the worker ends once it is free."""
    srv = BatchingServer(_FakePredictor(0.01, 0.01, 2), max_wait_ms=5.0)
    before = [srv.submit(b"x") for _ in range(3)]
    srv.close()
    assert all(f.result(timeout=30)["boxes"] == [] for f in before)
    after = srv.submit(b"x")
    with pytest.raises(ServerClosed):
        after.result(timeout=5)
    assert not srv._worker.is_alive()

    gate = threading.Event()
    srv = BatchingServer(_FakePredictor(0.0, 0.0, 1, gate=gate), max_wait_ms=0.0)
    first = srv.submit(b"x")  # the worker takes it and waits on the gate
    time.sleep(0.2)
    queued = srv.submit(b"x")
    srv.close(timeout=0.2)
    with pytest.raises(ServerClosed):
        queued.result(timeout=5)
    gate.set()
    assert first.result(timeout=30)["scores"] == []
    srv._worker.join(timeout=10)
    assert not srv._worker.is_alive()
    assert srv.snapshot()["errors"] == 1


def test_serve_cli_live_and_over_artifacts(tmp_path):
    """``serve.main`` on the CPU: a seeded model, then two named artifacts
    from the export CLI; each answers over HTTP and stops on shutdown."""
    from yolo_scratch_tpu_torch import export as E

    body = _png_bytes(np.random.RandomState(8))
    art = str(tmp_path / "a.pt2")
    E.main(["--imgsz", "64", "--batch", "2", "--conf", "0.0", "--out", art, "--device", "cpu"])
    for argv, route in (([], "/v1/detect"),
                        (["--artifact", f"det={art}", "--artifact", art], "/v1/detect/a")):
        ready = []
        th = threading.Thread(target=serve.main, args=(
            ["--imgsz", "64", "--batch", "2", "--conf", "0.0", "--port", "0", "--device", "cpu",
             *argv],), kwargs={"ready": ready.append}, daemon=True)
        th.start()
        for _ in range(600):
            if ready:
                break
            time.sleep(0.1)
        httpd = ready[0]
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            req = urllib.request.Request(f"{url}{route}", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                got = json.loads(r.read())
            assert set(got) == {"boxes", "scores", "labels"} and len(got["scores"]) > 0
            with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
                models = json.loads(r.read())["models"]
            assert models == (["yolo11"] if not argv else ["a", "det"])
        finally:
            httpd.shutdown()
        th.join(timeout=30)
        assert not th.is_alive()


def test_deploy_clis_default_to_cuda(monkeypatch, tmp_path):
    """The serve, export and int8 infer CLIs run on cuda unless told
    otherwise: with no GPU visible they raise instead of falling back."""
    from yolo_scratch_tpu_torch import export as E
    from yolo_scratch_tpu_torch import infer

    (tmp_path / "a.png").write_bytes(_png_bytes(np.random.RandomState(9)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: serve.main(["--imgsz", "64", "--port", "0"]),
                lambda: E.main(["--imgsz", "64", "--out", str(tmp_path / "m.pt2")]),
                lambda: infer.main(["--images", str(tmp_path), "--imgsz", "64",
                                    "--int8-calib", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            run()
