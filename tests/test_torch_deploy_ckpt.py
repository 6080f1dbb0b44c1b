"""The deploy CLIs (``infer``, ``export``, ``serve``) on a checkpoint the
port's ``train.cli`` wrote (``--ckpt DIR --which``) and on a reference
``.pt`` (``--torch-ckpt``), on the CPU at 64-96 px.

Stated tolerances: a checkpoint served through ``--ckpt`` equals the same
raw weights served through ``--weights``, exactly (the same program on the
same tensors), through each of the three CLIs; ``--ckpt`` serves the raw
weights and BN buffers, not the EMA, as the JAX CLIs do. ``--torch-ckpt``
against the JAX infer CLI on the same file, both f32: labels exact, scores
within 1e-5 and pixel boxes within 1e-5 of the unmap scale
(``tests/test_torch_infer.py``'s Predictor tolerances).
"""

import dataclasses
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_infer import _seeded_model
from tests.test_torch_train_step import one_torch_thread  # noqa: F401 (autouse fixture)
from yolo_scratch_tpu_torch import export as E
from yolo_scratch_tpu_torch import infer, serve
from yolo_scratch_tpu_torch.train import cli as tcli

IMG = 64
CPU = ["--device", "cpu", "--imgsz", str(IMG), "--batch", "2", "--conf", "0.0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A one-epoch ``train.cli`` run with EMA, its ``last`` checkpoint's raw
    state dict saved as a ``--weights`` file, and three PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("deploy")
    d = root / "run"
    tcli.main(["--device", "cpu", "--data", "synthetic", "--scale", "n", "--imgsz", str(IMG),
               "--batch", "4", "--epochs", "1", "--ema", "--save-dir", str(d)])
    tree = torch.load(d / "last.pt", map_location="cpu", weights_only=True)
    torch.save(tree["model"], root / "w.pt")
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(70, 90), (64, 64), (100, 60)]):
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(imgs / f"i{i}.png")
    return d, root / "w.pt", imgs, tree


def test_load_deploy_model_serves_raw_weights_not_ema(run):
    d, _, _, tree = run
    model = infer.load_deploy_model(ckpt=d, which="last", device="cpu")
    assert (model.in_ch, model.nc) == (1, 5)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in tree["model"].items())
    assert any(not torch.equal(sd[k], v) for k, v in tree["ema"].items())
    with pytest.raises(FileNotFoundError, match="no checkpoint 'best'"):
        infer.load_deploy_model(ckpt=d.parent / "imgs", which="best", device="cpu")


def test_infer_ckpt_equals_weights(run):
    d, w, imgs, _ = run
    got = infer.main(["--images", str(imgs), "--ckpt", str(d), "--which", "last"] + CPU)
    ref = infer.main(["--images", str(imgs), "--weights", str(w)] + CPU)
    assert got == ref and all(r["scores"] for r in got)


def test_export_ckpt_equals_weights(run, tmp_path):
    d, w, _, _ = run
    x = np.random.RandomState(1).randint(0, 256, (2, IMG, IMG, 1), dtype=np.uint8)
    outs = []
    for src in (["--ckpt", str(d), "--which", "last"], ["--weights", str(w)]):
        path = str(tmp_path / f"m{len(outs)}.pt2")
        E.main(src + CPU + ["--out", path, "--check"])
        outs.append(E.ArtifactPredictor(E.load_artifact(path)).predict_batch(x))
    assert torch.equal(outs[0], outs[1]) and outs[0][..., 6].sum() > 0


def _serve_one(argv, body):
    ready = []
    th = threading.Thread(target=serve.main, args=(argv,), kwargs={"ready": ready.append},
                          daemon=True)
    th.start()
    for _ in range(600):
        if ready or not th.is_alive():
            break
        time.sleep(0.1)
    httpd = ready[0]
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/v1/detect",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())
    finally:
        httpd.shutdown()
        th.join(timeout=30)


def test_serve_ckpt_equals_predict_paths(run):
    d, w, imgs, _ = run
    path = sorted(imgs.glob("*.png"))[0]
    got = _serve_one(["--ckpt", str(d), "--which", "last", "--port", "0"] + CPU,
                     path.read_bytes())
    pred = infer.Predictor(infer.load_deploy_model(weights=w, device="cpu"),
                           infer.PredictorConfig(img_size=IMG, batch_size=2,
                                                 conf_threshold=0.0), device="cpu")
    (ref,) = pred.predict_paths([str(path)])
    assert got == {k: ref[k] for k in ("boxes", "scores", "labels")} and got["scores"]


def test_wrong_nc_raises_naming_the_checkpoint(run):
    d, _, imgs, _ = run
    with pytest.raises(ValueError, match="checkpoint 'last': params do not match"):
        infer.main(["--images", str(imgs), "--ckpt", str(d), "--which", "last",
                    "--nc", "80"] + CPU)
    with pytest.raises(ValueError, match="checkpoint 'last'"):
        E.main(["--ckpt", str(d), "--which", "last", "--ch", "3", "--out", str(d / "unused.pt2")]
               + CPU)


def test_serve_artifact_is_exclusive_with_checkpoints(run):
    d, _, _, _ = run
    for src in (["--ckpt", str(d)], ["--torch-ckpt", "ref.pt"], ["--weights", "w.pt"]):
        with pytest.raises(SystemExit, match="--artifact is exclusive with"):
            serve.main(["--artifact", "m.pt2", "--port", "0", "--device", "cpu"] + src)


def test_torch_ckpt_matches_the_jax_cli(tmp_path, monkeypatch):
    """A reference-layout ``.pt`` (the state dict under ``model_state_dict``,
    with the reference's frozen DFL conv) through both infer CLIs, f32."""
    from yolo_scratch_tpu import infer as jinfer

    model = _seeded_model()
    sd = dict(model.state_dict())
    sd["model.23.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    ckpt = tmp_path / "ref.pt"
    torch.save({"model_state_dict": sd, "epoch": 3}, ckpt)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(3)
    from PIL import Image

    for i, (h, wd) in enumerate([(80, 100), (96, 96), (120, 70)]):
        buf = io.BytesIO()
        Image.fromarray((rng.rand(h, wd) * 255).astype(np.uint8)).save(buf, format="PNG")
        (imgs / f"i{i}.png").write_bytes(buf.getvalue())

    # both CLIs in f32: their PredictorConfig with bf16 off
    f32 = {mod: dataclasses.make_dataclass("F32", [("bf16", bool, False)],
                                           bases=(mod.PredictorConfig,))
           for mod in (infer, jinfer)}
    for mod, cls in f32.items():
        monkeypatch.setattr(mod, "PredictorConfig", cls)
    args = ["--images", str(imgs), "--torch-ckpt", str(ckpt), "--imgsz", "96", "--batch", "2"]
    got = infer.main(args + ["--device", "cpu"])
    ref = jinfer.main(args)
    assert [r["path"] for r in got] == [r["path"] for r in ref]
    for g, r in zip(got, ref):
        assert g["labels"] == r["labels"] and len(g["labels"]) > 0
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=1e-5 * 96 * 2)
    loaded = infer.load_deploy_model(torch_ckpt=ckpt, model_kind="yolox", device="cpu")
    assert not hasattr(loaded, "backbone")  # the reference has no YOLOX: always YOLO11
