"""The port's dGA NMS (``ops/dga_nms.py``) against the JAX functions and the
port's host scorer (``utils/metrics.py::cda_nms``), on
``tests/test_dga_nms_device.py``'s inputs.

Stated tolerances: the (N, N) Gaussian-angle matrix within 1e-6 absolute
of JAX's (both f32, the same closed form; arccos near 1 amplifies the last
ulp of its argument), on the JAX tests' sparse inputs (3 near-duplicates in
40 boxes) and on ``chip_smoke.py`` 11(d)'s dense ones (300 boxes, half of
them near-duplicates); keep sets exact, against JAX's and against the host
``cda_nms``'s.

The f64 witness: on the dense inputs the port, whose cos, sin, exp, arccos
and sqrt are rounded once from f64, lies no farther on average than JAX
from the same closed form evaluated in f64 throughout.
"""

import math

import numpy as np
import pytest
import torch

from yolo_scratch_tpu.ops.dga_nms import dga_nms_device as jax_dga_nms
from yolo_scratch_tpu.ops.dga_nms import pairwise_dga as jax_pairwise
from yolo_scratch_tpu_torch.ops.dga_nms import dga_nms_device, pairwise_dga
from yolo_scratch_tpu_torch.utils.metrics import cda_nms


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dups(seed, n=20):
    rng = np.random.RandomState(seed)
    c = rng.rand(n, 2).astype(np.float32) * 0.8 + 0.1
    wh = rng.rand(n, 2).astype(np.float32) * 0.15 + 0.03
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
    boxes[5] = boxes[0] + 0.002  # near-duplicates, to suppress
    boxes[6] = boxes[1] + 0.001
    boxes[7] = boxes[2] + 0.0015
    return boxes, rng.rand(n).astype(np.float32)


def _dense(seed, n=300):
    """``chip_smoke.py`` 11(d)'s input: the second half of the boxes are
    near-duplicates of the first, each corner moved by up to 0.003."""
    rng = np.random.RandomState(seed)
    c = rng.rand(n, 2).astype(np.float32) * 0.8 + 0.1
    wh = rng.rand(n, 2).astype(np.float32) * 0.15 + 0.03
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
    boxes[n // 2:] = boxes[: n - n // 2] + rng.uniform(0, 0.003, (n - n // 2, 4)).astype(
        np.float32)
    return boxes


@pytest.mark.parametrize("angles", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 3, 9])
def test_pairwise_dga_matches_jax(seed, angles):
    boxes, _ = _dups(seed, n=40)
    ang = None
    if angles:  # a rotated needle: its determinant cancels to <= 0 (the pi/2 fallback)
        ang = np.random.RandomState(seed).uniform(-1.5, 1.5, 40).astype(np.float32)
        boxes[11], ang[11] = [0.3, 0.3, 0.6, 0.3 + 1e-6], 0.7
    ref = np.asarray(jax_pairwise(boxes, ang))
    got = pairwise_dga(torch.from_numpy(boxes),
                       None if ang is None else torch.from_numpy(ang)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if angles:
        assert (got[11] == np.float32(math.pi / 2)).all() and (ref[11] == got[11]).all()


@pytest.mark.parametrize("seed", [13, 0])
def test_pairwise_dga_matches_jax_on_dense_duplicates(seed):
    boxes = _dense(seed)
    ref = np.asarray(jax_pairwise(boxes))
    got = pairwise_dga(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    exact = pairwise_dga(torch.from_numpy(boxes).double()).numpy()  # f64 throughout
    assert np.abs(got - exact).mean() <= np.abs(ref - exact).mean()


@pytest.mark.parametrize("seed", [0, 3, 9])
@pytest.mark.parametrize("max_det", [10, 3])
def test_dga_nms_matches_jax_and_host(seed, max_det):
    boxes, scores = _dups(seed)
    valid = np.ones(len(boxes), bool)
    valid[4] = False
    ref = np.asarray(jax_dga_nms(boxes, scores, valid, max_det=max_det, dga_thresh=0.15))
    got = dga_nms_device(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid), max_det=max_det, dga_thresh=0.15).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == max_det
    # the host scorer (all boxes valid), as a set of rows
    keep = dga_nms_device(torch.from_numpy(boxes), torch.from_numpy(scores), max_det=max_det)
    host = cda_nms({"boxes": boxes, "scores": scores}, max_detections=max_det, dga_thresh=0.15)
    assert ({tuple(np.round(r, 6)) for r in boxes[keep.numpy()]}
            == {tuple(np.round(r, 6)) for r in host["boxes"]})
    assert not keep[5:8].all()  # a near-duplicate went
