"""Port NMS past 4096 candidates against the JAX package, whose Pallas sweep
takes any N (it pads N to a multiple of 128): the plain sweeps, the fused
postprocess at every anchor of a 640 image, and the Predictor at 448 px,
the smallest multiple of 32 with more than 4096 anchors (4,116).

Stated tolerances:

* keep masks, labels and valid: exact (the plain sweep repeats the Pallas
  kernel's f32 operation order).
* ``postprocess_from_feats``: scores within 2 ulp, normalised boxes within
  ``atol = 2e-6``, as ``tests/test_torch_decode.py`` states and argues.
* the f32 Predictor: scores and normalised boxes within ``atol = 1e-5``, as
  ``tests/test_torch_infer.py`` states and argues.

The CUDA kernels at these N are held against the plain sweeps on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` 11(c)).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_scratch_tpu.infer import Predictor as JaxPredictor
from yolo_scratch_tpu.infer import PredictorConfig as JaxConfig
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.ops import pallas_nms as jpallas
from yolo_scratch_tpu.ops.decode import postprocess_from_feats as jax_from_feats
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch import infer
from yolo_scratch_tpu_torch.models.builder import build_yolo11
from yolo_scratch_tpu_torch.ops import nms_kernels as tk
from yolo_scratch_tpu_torch.ops.decode import postprocess_from_feats

# YOLO11 at width 1/128 (every width at make_divisible's floor of 8): the
# committed JAX-checkpoint fixture's config, a JSON text both builders read
TINY_CFG = str(Path(__file__).resolve().parent / "fixtures/jax_ckpt/yolo11_crater_tiny.yaml")
REG, STRIDES = 16, (8.0, 16.0, 32.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, shape):
    """Detection-like candidates on a 640 canvas (``chip_smoke.seeded_boxes``)."""
    c = rng.uniform(0, 640, (*shape, 2))
    wh = rng.uniform(4, 160, (*shape, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


# (N, IoU threshold): one word past the register reduce's 64 words, a whole
# 128-lane multiple, every anchor of a 640 image; a negative threshold
# (every pair suppresses, the divide is never skipped)
SWEEP_CASES = [(4097, 0.45), (4160, 0.45), (8400, 0.45), (4160, -0.1)]


@pytest.mark.parametrize("n,iou", SWEEP_CASES)
def test_batched_plain_sweep_past_4096_matches_pallas(n, iou):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, (2, n))
    valid = rng.rand(2, n) > 0.15
    ref = np.asarray(jpallas.nms_sweep_pallas_batched(boxes, valid, iou, interpret=True))
    got = tk.nms_sweep_batched(torch.from_numpy(boxes), torch.from_numpy(valid), iou).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("n", [4097, 8400])
def test_single_plain_sweep_past_4096_matches_pallas(n):
    rng = np.random.RandomState(n + 1)
    boxes = _boxes(rng, (n,))
    valid = rng.rand(n) > 0.15
    ref = np.asarray(jpallas.nms_sweep_pallas(boxes, valid, 0.45, interpret=True))
    got = tk.nms_sweep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()


def _head_maps(seed, nc, img=640, B=2):
    """Seeded raw Detect maps (B, H, W, 4*REG + nc) of an ``img`` image."""
    rng = np.random.RandomState(seed)
    maps = []
    for s in STRIDES:
        g = int(img // s)
        box = rng.normal(0.0, 2.0, (B, g, g, 4 * REG))
        cls = rng.normal(-0.5, 2.0, (B, g, g, nc))
        maps.append(np.concatenate([box, cls], -1).astype(np.float32))
    return maps


@pytest.mark.parametrize("nc", [5, 80], ids=["crater", "coco"])
def test_postprocess_from_feats_at_every_anchor_matches_pallas(nc):
    """``pre_nms_topk=8400`` at conf 0 on a 640 image's maps: every one of
    the 8,400 anchors goes through the sweep, kernel #1's path at B=2 (its
    plain version here) against JAX's ``nms_impl="pallas"``."""
    maps = _head_maps(nc, nc)
    kw = dict(nc=nc, strides=STRIDES, img_size=640, conf_threshold=0.0, iou_threshold=0.45,
              max_det=300, pre_nms_topk=8400)
    rb, rs, rl, rv = (np.asarray(r) for r in
                      jax_from_feats([jnp.asarray(m) for m in maps], nms_impl="pallas", **kw))
    gb, gs, gl, gv = (t.numpy() for t in
                      postprocess_from_feats([torch.from_numpy(m) for m in maps],
                                             nms_impl="kernel", **kw))
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_array_max_ulp(gs, rs, maxulp=2)
    np.testing.assert_allclose(gb, rb, rtol=0, atol=2e-6)
    assert rv.sum(1).min() == 300  # the sweep keeps more than max_det: the cap binds


def _seeded_tiny_model():
    """The tiny YOLO11 with randomised BN statistics and zeroed class-bias
    priors (``tests/test_torch_infer.py``'s recipe, so that scores pass the
    confidence gate), BN scales drawn from [0.7, 1.2): at
    ``test_torch_infer``'s [0.3, 0.8) the image's signal dies out over the
    layers, the class logits of most anchors tie to the last f32 bit, and
    each framework's rounding then orders the ties its own way."""
    model = build_yolo11(TINY_CFG, ch=1, nc=5, scale="t", seed=7)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.7, 1.2, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
        for cls in model.model[-1].cv3:
            cls[2].bias.zero_()
    return model.eval()


def test_predictor_at_448_with_topk_8400_matches_jax():
    """``--topk 8400`` at 448 px, B=2, f32: the sweep runs over all 4,116
    anchors (k = min(topk, A)), past the 4096 boxes kernel #1 once took."""
    tm = _seeded_tiny_model()
    params, stats = convert_reference_state_dict(tm.state_dict())
    jm = jax_build(TINY_CFG, ch=1, nc=5, scale="t")
    common = dict(img_size=448, batch_size=2, conf_threshold=0.25, bf16=False,
                  pre_nms_topk=8400)
    tp = infer.Predictor(tm, infer.PredictorConfig(**common), device="cpu")
    jp = JaxPredictor(jm, {"params": params, "batch_stats": stats},
                      JaxConfig(nms_impl="pallas", **common))
    x = np.random.RandomState(3).randint(0, 256, (2, 448, 448, 1)).astype(np.uint8)
    got, ref = tp.predict_batch(x).numpy(), np.asarray(jp._infer_packed(jp.variables, x))
    assert got.shape == ref.shape == (2, 300, 7)
    np.testing.assert_array_equal(got[..., 6], ref[..., 6])  # valid
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])  # labels
    np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=1e-5)
    assert got[..., 6].sum(1).min() >= 3  # detections exist in every image


def test_chunk_images_keeps_the_scratch_under_its_cap(monkeypatch):
    """The wrapper's chunk rule: as many images as keep the IoU mask's
    scratch within the cap, at least one, at most the batch."""
    stride = 132  # N = 8400: ceil(8400 / 64) words a row
    image = 8400 * stride * 8
    assert tk._chunk_images(32, 8400, stride) == 32
    assert tk._chunk_images(128, 8400, stride) == 64
    assert 64 * image <= tk._SCRATCH_CAP_BYTES < 128 * image
    monkeypatch.setattr(tk, "_SCRATCH_CAP_BYTES", image // 2)
    assert tk._chunk_images(128, 8400, stride) == 1
