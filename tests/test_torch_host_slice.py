"""The host slice as a whole: the port's ``Predictor.predict_paths`` (host prep
through the port's own PNG/JPEG decoders, ``csrc/yst_host.cpp`` of the port)
against the JAX ``Predictor.predict_paths`` (host prep through the JAX
package's native tier, libpng and libjpeg-turbo) on the same files and the
same weights.

The JAX side's native library is the reference build of
``test_torch_host_codecs.py`` (the JAX package's ``csrc/yst_host.cpp`` with
``-lpng -ljpeg -lz``, built in this session's temporary directory), put in
place of the one ``yolo_scratch_tpu.data.native`` would build under
``csrc/``. The model is ``test_torch_infer.py``'s seeded crater YOLO11n,
carried to JAX and back into the port by ``utils/weights.py``, f32, at 96
px, with the files larger than the canvas so that ``fast_jpeg`` decodes
the JPEGs at a reduced scale on both sides.

Stated tolerances: the host batches are equal byte for byte (the codecs are
exact on these files), so the detections carry only the forward's
tolerance of ``test_torch_infer.py``: keep sets (labels, count) exact,
scores ``atol = 1e-5``, normalised boxes ``atol = 1e-5``, i.e. ``2e-5``
times the longer side in pixels.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_host_codecs import build_reference
from test_torch_infer import JAX_CFG, _seeded_model
from yolo_scratch_tpu.data import native as jax_native
from yolo_scratch_tpu.infer import Predictor as JaxPredictor
from yolo_scratch_tpu.infer import PredictorConfig as JaxConfig
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch import host, infer
from yolo_scratch_tpu_torch.data import native
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

IMG, B, CONF = 96, 4, 0.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_reference_tier(tmp_path_factory):
    """The JAX package's native tier, loaded from the reference build."""
    so = build_reference(tmp_path_factory.mktemp("ref_slice"))
    saved = (jax_native._SO, jax_native._lib, jax_native._tried)
    jax_native._SO, jax_native._lib, jax_native._tried = so, None, False
    assert jax_native.available()
    yield
    jax_native._SO, jax_native._lib, jax_native._tried = saved


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Crater-like gray and colour images larger than the canvas, as PNG,
    baseline JPEG (4:4:4 / 4:2:0) and progressive JPEG."""
    d = tmp_path_factory.mktemp("slice_files")
    rng = np.random.RandomState(11)
    paths = []
    for i, (h, w) in enumerate([(150, 200), (240, 320), (130, 100), (300, 220), (97, 97)]):
        y, x = np.mgrid[0:h, 0:w]
        img = 110 + 60 * np.sin(x / (5.0 + i)) * np.cos(y / 7.0) + rng.randn(h, w) * 12
        for cx, cy, r in rng.uniform(0.2, 0.8, (4, 3)) * [w, h, min(h, w) / 3]:
            img -= 70 * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * r * r))
        gray = np.clip(img, 0, 255).astype(np.uint8)
        im = Image.fromarray(np.stack([gray, gray // 2 + 60, 255 - gray], -1) if i % 2 else gray)
        for fmt, kw in [("png", {}), ("jpg", {"quality": 90, "subsampling": i % 3}),
                        ("jpg", {"quality": 75, "progressive": True})]:
            p = d / f"f{i}_{len(paths)}.{fmt}"
            im.save(p, "PNG" if fmt == "png" else "JPEG", **kw)
            paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def predictors():
    """The seeded model's weights as JAX variables, and the port's model
    loaded back from those variables by ``utils/weights.py``."""
    params, stats = convert_reference_state_dict(_seeded_model().state_dict())
    variables = {"params": params, "batch_stats": stats}
    tm = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    tm.load_state_dict(state_dict_from_jax(variables))
    jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
    kw = dict(img_size=IMG, batch_size=B, conf_threshold=CONF, bf16=False)
    return (infer.Predictor(tm.eval(), infer.PredictorConfig(**kw), device="cpu"),
            JaxPredictor(jm, variables, JaxConfig(nms_impl="pallas", **kw)))


@pytest.mark.parametrize("fast_jpeg", [True, False])
def test_host_batches_equal_reference_tier(jax_reference_tier, predictors, files, fast_jpeg):
    """One batch of host prep each side: uint8 images and meta equal."""
    tp, jp = predictors
    tp.cfg.fast_jpeg = jp.cfg.fast_jpeg = fast_jpeg
    try:
        got, gmeta = host.prepare_images(files, tp.cfg, 1)
        want, wmeta = jp._prepare(files)
    finally:
        tp.cfg.fast_jpeg = jp.cfg.fast_jpeg = True
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(gmeta, np.asarray(wmeta))


def test_predict_paths_matches_jax(jax_reference_tier, predictors, files):
    tp, jp = predictors
    assert native.available()
    got = list(tp.predict_paths(files))
    ref = list(jp.predict_paths(files))
    assert [g["path"] for g in got] == [r["path"] for r in ref] == files
    for g, r in zip(got, ref):
        assert g["labels"] == r["labels"] and len(g["labels"]) > 0
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=1e-5)
        w0, h0 = Image.open(g["path"]).size
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=2e-5 * max(w0, h0))
