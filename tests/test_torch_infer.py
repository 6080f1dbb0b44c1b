"""Port Predictor (yolo_scratch_tpu_torch.infer) vs the JAX Predictor on the
same weights, plus the port's device rule and CLI.

The weights come from the port's seeded init with randomised BN statistics
and zeroed class-bias priors, carried to the JAX side by
``convert_reference_state_dict``. (The prior alone puts every class score
near 1.6e-4, so nothing would pass a confidence gate.)

Stated tolerances (f32 Predictor, BN folded on both sides): labels and
valid exact; scores ``atol = 1e-5``; normalised boxes ``atol = 1e-5``. The
forward passes sum conv products in different orders, so logits and box
distances differ at ~1e-6 relative; 1e-5 leaves room for that and for no
real fault. The bf16 raw maps agree to ``atol = 0.03 * max|ref|``: both
sides round every layer's output to bf16 (8 bits of mantissa, 2^-8 = 0.004
relative), but at different places, and ~100 layers compound it.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.infer import Predictor as JaxPredictor
from yolo_scratch_tpu.infer import PredictorConfig as JaxConfig
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch import infer
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11

IMG, B, CONF = 96, 2, 0.25
JAX_CFG = str(CONFIGS.parent.parent / "yolo_scratch_tpu/configs/yolo11_crater.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_model():
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=7)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.3, 0.8, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
        for cls in model.model[-1].cv3:
            cls[2].bias.zero_()
    return model.eval()


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model, JAX variables with the same weights)."""
    tm = _seeded_model()
    params, stats = convert_reference_state_dict(tm.state_dict())
    jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
    return tm, jm, {"params": params, "batch_stats": stats}


def _config(**kw):
    return dict(img_size=IMG, batch_size=B, conf_threshold=CONF, bf16=False, **kw)


@pytest.fixture(scope="module")
def predictors(models):
    tm, jm, v = models
    return (infer.Predictor(tm, infer.PredictorConfig(**_config()), device="cpu"),
            JaxPredictor(jm, v, JaxConfig(**_config(nms_impl="pallas"))))


def _images(seed):
    return np.random.RandomState(seed).randint(0, 256, (B, IMG, IMG, 1)).astype(np.uint8)


def _assert_packed_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape == (B, 300, 7)
    np.testing.assert_array_equal(got[..., 6], ref[..., 6])  # valid
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])  # labels
    np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_predictor_matches_jax(predictors, seed):
    tp, jp = predictors
    x = _images(seed)
    got = tp.predict_batch(x).numpy()
    ref = jp._infer_packed(jp.variables, x)
    _assert_packed_close(got, ref)
    assert got[..., 6].sum(1).min() >= 3  # detections exist in every image


def test_bf16_raw_maps_match_jax(models):
    tm, jm, v = models
    x = _images(2)
    tp = infer.Predictor(tm, infer.PredictorConfig(img_size=IMG), device="cpu")
    got = tp.forward_feats(x)
    fused = jax_fuse(v)
    fused = {**fused, "params": jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                                       fused["params"])}
    ref = jax.jit(lambda vv, xx: jm.apply(vv, xx.astype(jnp.bfloat16) / 255.0))(fused, x)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=0.03 * np.abs(r).max())


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(80, 100), (96, 96), (120, 70)]):  # odd count: padded batch
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(d / f"i{i}.png")
    return d


def test_predict_paths_matches_jax(predictors, png_dir):
    tp, jp = predictors
    paths = sorted(str(p) for p in png_dir.glob("*.png"))
    got = list(tp.predict_paths(paths))
    ref = list(jp.predict_paths(paths))
    assert [r["path"] for r in got] == [r["path"] for r in ref] == paths
    for g, r in zip(got, ref):
        assert g["labels"] == r["labels"] and len(g["labels"]) > 0
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-5)
        # pixel boxes: the 1e-5 normalised tolerance times the unmap scale
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=1e-5 * IMG * 2)


def test_entry_points_default_to_cuda_and_raise_without_it(models, monkeypatch, png_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        infer.Predictor(models[0])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        infer.load_deploy_model()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        infer.main(["--images", str(png_dir)])
    assert infer.Predictor(models[0], device="cpu").device.type == "cpu"


def test_cli_serves_state_dict_and_reads_dims(tmp_path, png_dir):
    """--weights: (ch, nc) come off the state_dict (here 3/80), and the CLI
    streams detections end to end on the CPU."""
    model = build_yolo11(CONFIGS / "yolo11_coco.json", ch=3, nc=80, scale="n", seed=1)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    loaded = infer.load_deploy_model(weights=tmp_path / "w.pt", device="cpu")
    assert (loaded.in_ch, loaded.nc) == (3, 80)
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                 model.state_dict().values()))
    out = tmp_path / "preds.json"
    results = infer.main(["--images", str(png_dir), "--weights", str(tmp_path / "w.pt"),
                          "--imgsz", "64", "--batch", "2", "--conf", "0.0",
                          "--class-aware", "--device", "cpu", "--out", str(out)])
    data = json.loads(out.read_text())
    assert len(results) == len(data) == 3
    for row in data:
        assert row["labels"] and all(0 <= lab < 80 for lab in row["labels"])


@pytest.fixture
def cv2_tier(monkeypatch):
    """Both packages' host prep on their cv2 tier, as where the native
    library does not build (the card's machine)."""
    from yolo_scratch_tpu.data import native as jax_native
    from yolo_scratch_tpu_torch.data import native

    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("letterbox", [True, False], ids=["letterbox", "stretch"])
@pytest.mark.parametrize("ch", [1, 3], ids=["gray", "rgb"])
def test_prepare_cv2_tier_matches_jax(cv2_tier, tmp_path, letterbox, ch):
    """The port's cv2 tier against the JAX package's, exactly: float32 / 255
    images (even with u8_transfer on), BGR -> RGB, 114 padding, round()ed
    sizes, meta rows [w0, h0, r, px, py] with r = 0 for stretch; an
    undecodable file raises IOError on both."""
    import types

    import cv2

    rng = np.random.RandomState(ch)
    paths = []
    for i, (h, w) in enumerate([(80, 100), (96, 96), (131, 57), (40, 200)]):
        p = str(tmp_path / f"c{i}.png")
        cv2.imwrite(p, (rng.rand(h, w, 3) * 255).astype(np.uint8))
        paths.append(p)
    cfg = dict(img_size=IMG, letterbox=letterbox)
    jax_self = types.SimpleNamespace(cfg=JaxConfig(**cfg), in_ch=ch)
    port_self = types.SimpleNamespace(cfg=infer.PredictorConfig(**cfg), in_ch=ch)
    ref_imgs, ref_meta = JaxPredictor._prepare(jax_self, paths)
    imgs, meta = infer.Predictor._prepare(port_self, paths)
    assert imgs.dtype == ref_imgs.dtype == np.float32 and imgs.shape == (4, IMG, IMG, ch)
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(meta, ref_meta)
    assert (meta[:, 2] > 0).all() == letterbox and (meta[:, 2] == 0).all() == (not letterbox)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    for fn, self_ in ((JaxPredictor._prepare, jax_self), (infer.Predictor._prepare, port_self)):
        with pytest.raises(IOError):
            fn(self_, [paths[0], str(bad)])


def test_predict_paths_through_cv2_tier_matches_jax(predictors, png_dir, cv2_tier):
    """predict_paths where the native library is missing: the port's and
    the JAX package's detections agree (the Predictor tolerances above)."""
    tp, jp = predictors
    paths = sorted(str(p) for p in png_dir.glob("*.png"))
    got = list(tp.predict_paths(paths))
    ref = list(jp.predict_paths(paths))
    assert [r["path"] for r in got] == paths
    for g, r in zip(got, ref):
        assert g["labels"] == r["labels"] and len(g["labels"]) > 0
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=1e-5 * IMG * 2)
