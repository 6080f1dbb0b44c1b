"""The port's ``torch.export`` serving artifacts (``export.py``), the analog
of ``tests/test_export.py``, on the CPU.

The artifact runs the program the live Predictor runs (the same ops, the
NMS through the ``yst::nms_sweep_batched`` op, whose CPU kernel is the plain
sweep), so its outputs must equal the live Predictor's exactly: boxes,
scores, labels and valid, for YOLO11 and YOLOX, u8 and f32 input, and
``predict_paths`` / the daemon's responses bit for bit. The daemon tests
drive it over HTTP with one artifact and with two named ones.
"""

import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_infer import _seeded_model
from tests.test_torch_train_step import one_torch_thread  # noqa: F401 (autouse fixture)
from yolo_scratch_tpu_torch import export as E
from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.serve import BatchingServer, make_http_server, parse_artifact_spec

REPO = Path(__file__).resolve().parent.parent
IMGSZ = 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return _seeded_model()


def _predictor(model, nms_impl="kernel", class_aware=False, u8=True, letterbox=True, B=2):
    cfg = PredictorConfig(img_size=IMGSZ, batch_size=B, conf_threshold=0.25, max_det=32,
                          pre_nms_topk=64, nms_impl=nms_impl, class_aware_nms=class_aware,
                          u8_transfer=u8, letterbox=letterbox)
    return Predictor(model, cfg, device="cpu")


def _rand_batch(u8=True, ch=1, B=2):
    x = np.random.default_rng(7).integers(0, 256, size=(B, IMGSZ, IMGSZ, ch), dtype=np.uint8)
    return x if u8 else x.astype(np.float32) / 255.0


def _roundtrip(pred, tmp_path, name="m.pt2", **kw):
    path = str(tmp_path / name)
    nbytes = E.save_artifact(E.export_predictor(pred), path, **kw)
    assert nbytes > 1000
    return path, E.load_artifact(path)


def _assert_outputs_equal(got, live):
    assert [t.dtype for t in got] == [torch.float32, torch.float32, torch.int32, torch.bool]
    for g, r in zip(got, live):
        assert torch.equal(g, r)


@pytest.mark.parametrize("nms_impl,class_aware", [("kernel", False), ("pairwise", True)])
def test_export_roundtrip_matches_live(model, tmp_path, nms_impl, class_aware):
    pred = _predictor(model, nms_impl, class_aware)
    x = _rand_batch()
    with torch.inference_mode():
        live = pred._infer(x)
    assert live[3].sum() > 0, "the seeded model must detect something at conf 0.25"
    _, art = _roundtrip(pred, tmp_path)
    x_spec, outs = E._io_specs(art)
    assert tuple(x_spec.shape) == (2, IMGSZ, IMGSZ, 1) and x_spec.dtype == torch.uint8
    assert [tuple(o.shape) for o in outs] == [(2, 32, 4), (2, 32), (2, 32), (2, 32)]
    targets = [str(n.target) for n in art.graph.nodes]
    assert targets.count("yst.nms_sweep_batched.default") == (nms_impl == "kernel")
    with torch.inference_mode():
        got = art.module()(torch.from_numpy(x))
    _assert_outputs_equal(got, live)


def test_export_enforces_input_shape(model, tmp_path):
    pred = _predictor(model)
    path = str(tmp_path / "b4.pt2")
    E.save_artifact(E.export_predictor(pred, batch_size=4), path)
    art = E.ArtifactPredictor(E.load_artifact(path))
    assert art.cfg.batch_size == 4 and art.cfg.img_size == IMGSZ
    with pytest.raises(AssertionError, match="size"):
        art.predict_batch(_rand_batch())  # B=2 into a B=4 artifact


def test_export_f32_input_variant(model, tmp_path):
    pred = _predictor(model, u8=False)
    x = _rand_batch(u8=False)
    with torch.inference_mode():
        live = pred._infer(x)
    _, art = _roundtrip(pred, tmp_path)
    assert E._io_specs(art)[0].dtype == torch.float32
    with torch.inference_mode():
        got = art.module()(torch.from_numpy(x))
    _assert_outputs_equal(got, live)
    assert not E.ArtifactPredictor(art).cfg.u8_transfer


def test_export_roundtrip_yolox(tmp_path):
    """YOLOX exports the same way: f32 decode + the common postprocess."""
    model = build_yolox("nano", nc=5, ch=3, seed=0)
    pred = Predictor(model, PredictorConfig(img_size=IMGSZ, batch_size=2, conf_threshold=1e-5,
                                            max_det=32, pre_nms_topk=64), device="cpu")
    x = _rand_batch(ch=3)
    with torch.inference_mode():
        live = pred._infer(x)
    assert live[3].sum() > 0
    _, art = _roundtrip(pred, tmp_path, "yolox.pt2")
    assert tuple(E._io_specs(art)[0].shape) == (2, IMGSZ, IMGSZ, 3)
    with torch.inference_mode():
        got = art.module()(torch.from_numpy(x))
    _assert_outputs_equal(got, live)


def _write_images(tmp_path, n, w=100, h=80):
    import cv2

    paths = []
    for i in range(n):
        p = str(tmp_path / f"im{i}.png")
        cv2.imwrite(p, (np.random.RandomState(i).rand(h, w) * 255).astype(np.uint8))
        paths.append(p)
    return paths


def test_artifact_predictor_streams_like_live(model, tmp_path):
    """ArtifactPredictor runs the whole streaming path (host prep -> the
    artifact's program -> unmap) with the live Predictor's results, its
    geometry read off the artifact alone."""
    pred = _predictor(model)
    path, art = _roundtrip(pred, tmp_path)
    art_pred = E.ArtifactPredictor(art)
    assert art_pred.cfg.img_size == IMGSZ and art_pred.cfg.batch_size == 2
    assert art_pred.cfg.max_det == 32 and art_pred.in_ch == 1 and art_pred.cfg.u8_transfer
    assert art_pred.device == torch.device("cpu")

    paths = _write_images(tmp_path, 5)  # B=2: two full batches and a padded tail
    live = list(pred.predict_paths(paths))
    via = list(art_pred.predict_paths(paths))
    assert [r["path"] for r in via] == paths
    assert via == live
    assert sum(len(r["scores"]) for r in live) > 0


def test_artifact_host_prep_sidecar_roundtrip(model, tmp_path):
    """The sidecar drives the server side's host prep: a stretch-exported
    artifact served through it does not letterbox."""
    pred = _predictor(model, letterbox=False)
    path, art = _roundtrip(pred, tmp_path, host_prep={"letterbox": False, "fast_jpeg": True})
    prep = E.load_host_prep(path)
    assert prep == {"letterbox": False, "fast_jpeg": True}
    art_pred = E.ArtifactPredictor(art, host_prep=prep)
    assert art_pred.cfg.letterbox is False
    # non-square sources make stretch and letterbox tell apart
    paths = _write_images(tmp_path, 3, w=96, h=192)
    assert list(art_pred.predict_paths(paths)) == list(pred.predict_paths(paths))
    letterboxed = E.ArtifactPredictor(art)
    assert list(letterboxed.predict_paths(paths)) != list(pred.predict_paths(paths))
    path2 = str(tmp_path / "bare.pt2")
    E.save_artifact(art, path2)
    assert E.load_host_prep(path2) is None


def test_u8_artifact_takes_the_cv2_tiers_float_input(model, tmp_path, monkeypatch):
    """Where the native library does not build, host prep gives float32 /
    255; a uint8 artifact gets the exact uint8 back and answers as it does
    on the native tier's uint8."""
    from yolo_scratch_tpu_torch.data import native

    pred = _predictor(model)
    _, art = _roundtrip(pred, tmp_path)
    art_pred = E.ArtifactPredictor(art)
    paths = _write_images(tmp_path, 2)
    imgs_u8, meta_u8 = art_pred._prepare(paths)
    monkeypatch.setattr(native, "available", lambda: False)
    imgs_f, meta_f = art_pred._prepare(paths)
    assert imgs_f.dtype == np.float32 and imgs_u8.dtype == np.uint8
    # the two tiers resize alike but not bit for bit; map the native tier's
    # uint8 through the cv2 tier's float encoding instead
    as_float = imgs_u8.astype(np.float32) / 255
    assert torch.equal(art_pred.predict_batch(as_float), art_pred.predict_batch(imgs_u8))
    assert tuple(art_pred.predict_batch(imgs_f).shape) == (2, 32, 7)
    np.testing.assert_array_equal(meta_f[:, :2], meta_u8[:, :2])


def test_loading_an_artifact_imports_no_model_code(model, tmp_path):
    """A serving process over an artifact imports the op registrations and
    the host side, never the model, builder or Predictor modules."""
    path, _ = _roundtrip(_predictor(model), tmp_path)
    code = f"""
import sys, numpy as np
from yolo_scratch_tpu_torch.export import ArtifactPredictor, load_artifact
from yolo_scratch_tpu_torch.serve import BatchingServer
pred = ArtifactPredictor(load_artifact({path!r}))
out = pred.predict_batch(np.zeros((2, {IMGSZ}, {IMGSZ}, 1), np.uint8))
BatchingServer(pred).close()
bad = sorted(m for m in sys.modules if m.startswith(("yolo_scratch_tpu_torch.models",
             "yolo_scratch_tpu_torch.nn", "yolo_scratch_tpu_torch.infer",
             "yolo_scratch_tpu_torch.losses", "yolo_scratch_tpu_torch.train", "jax")))
print(tuple(out.shape), bad)
sys.exit(1 if bad else 0)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "(2, 32, 7) []" in proc.stdout


def test_export_cli_check(tmp_path, capsys):
    """The export CLI writes the artifact and its sidecar, then loads it and
    runs a zeros batch (--check)."""
    out = str(tmp_path / "cli.pt2")
    E.main(["--imgsz", "64", "--batch", "2", "--stretch", "--out", out, "--check",
            "--device", "cpu"])
    log = capsys.readouterr().out
    assert "check ok: packed (2, 300, 7)" in log and "device cpu" in log
    prep = E.load_host_prep(out)
    assert prep["letterbox"] is False and prep["baked"]["nms_impl"] == "kernel"


def test_serve_artifact_spec_parsing():
    """NAME=PATH splitting does not eat a '=' inside the path."""
    assert parse_artifact_spec("det=models/a.pt2") == ("det", "models/a.pt2")
    assert parse_artifact_spec("models/a.pt2") == ("a", "models/a.pt2")
    assert parse_artifact_spec("runs/lr=0.01/m.pt2") == ("m", "runs/lr=0.01/m.pt2")
    assert parse_artifact_spec("det=runs/lr=0.01/m.pt2") == ("det", "runs/lr=0.01/m.pt2")


def _png(seed, w=100, h=80):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.random.RandomState(seed).rand(h, w) * 255).astype(np.uint8),
                    mode="L").save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


@pytest.fixture
def http(request):
    """Start make_http_server over the given BatchingServer(s); stop all."""
    started = []

    def start(servers):
        httpd = make_http_server(servers, port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        started.append((httpd, t, servers))
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    yield start
    for httpd, t, servers in started:
        httpd.shutdown()
        httpd.server_close()
        for s in (servers.values() if isinstance(servers, dict) else [servers]):
            s.close()
        t.join(timeout=10)
        assert not t.is_alive()


def test_serve_daemon_over_artifact(model, tmp_path, http):
    """The daemon serves an artifact with no model code: its response equals
    predict_paths through the same artifact, in original pixels."""
    path, art = _roundtrip(_predictor(model), tmp_path)
    art_pred = E.ArtifactPredictor(art)
    url = http(BatchingServer(art_pred, max_wait_ms=25.0))
    body = _png(3)
    got = _post(f"{url}/v1/detect", body)
    src = tmp_path / "req.png"
    src.write_bytes(body)
    (ref,) = art_pred.predict_paths([str(src)])
    assert got == {k: ref[k] for k in ("boxes", "scores", "labels")}
    assert got["scores"]
    for x1, y1, x2, y2 in got["boxes"]:
        assert 0 <= x1 <= x2 <= 100 and 0 <= y1 <= y2 <= 80


def test_multi_model_daemon_routes_by_name(model, tmp_path, http):
    """Two artifacts behind one daemon: /v1/detect/<name> goes to that
    model's own queue, /v1/detect to the first; /healthz reports each;
    unknown names 404."""
    servers = {}
    for name, conf in (("alpha", 0.25), ("beta", 0.8)):
        pred = _predictor(model)
        pred.cfg.conf_threshold = conf
        path, art = _roundtrip(pred, tmp_path, f"{name}.pt2")
        servers[name] = BatchingServer(E.ArtifactPredictor(art), max_wait_ms=10.0)
    url = http(servers)
    png = _png(5)
    beta = _post(f"{url}/v1/detect/beta", png)
    alpha = _post(f"{url}/v1/detect", png)
    assert set(alpha) == set(beta) == {"boxes", "scores", "labels"}
    assert len(beta["scores"]) < len(alpha["scores"])  # beta's baked conf is higher
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body["models"] == ["alpha", "beta"] and body["model"] == "alpha"
    assert body["stats"]["alpha"]["requests"] == body["stats"]["beta"]["requests"] == 1
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/v1/detect/nope", png)
    assert e.value.code == 404
