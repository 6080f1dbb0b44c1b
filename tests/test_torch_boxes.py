"""Port box geometry, anchors and the small head functions
(yolo_scratch_tpu_torch.ops.boxes / ops.anchors / nn.modules) vs the JAX
package on identical f32 inputs.

Exact wherever both sides run the same elementwise f32 operations in the
same order (box conversions, IoU, anchors, upsample). ``dfl_expectation``
sums a 16-bin softmax, whose reduction order differs between the
frameworks: ``atol = 1e-5`` on bin-index units (0..15), a few ulps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_scratch_tpu.nn.modules import dfl_expectation as jax_dfl
from yolo_scratch_tpu.nn.modules import upsample2x as jax_upsample2x
from yolo_scratch_tpu.ops import anchors as janchors
from yolo_scratch_tpu.ops import boxes as jboxes
from yolo_scratch_tpu_torch.nn.modules import dfl_expectation, upsample2x
from yolo_scratch_tpu_torch.ops import anchors as tanchors
from yolo_scratch_tpu_torch.ops import boxes as tboxes


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xyxy(rng, n):
    c = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(0.5, 40, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["xywh2xyxy", "xyxy2xywh"])
def test_box_conversions_exact(fn):
    b = _xyxy(np.random.RandomState(0), 50).reshape(5, 10, 4)
    got = getattr(tboxes, fn)(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jboxes, fn)(jnp.asarray(b))))


def test_pairwise_iou_exact():
    rng = np.random.RandomState(1)
    a, b = _xyxy(rng, 40), _xyxy(rng, 30)
    b[:5] = a[:5]  # identical pairs: IoU 1 up to the 1e-6 eps
    got = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, ref)
    assert (got > 0).mean() > 0.05 and (got[:5, :5].diagonal() > 0.999).all()


@pytest.mark.parametrize("xywh", [True, False])
def test_dist2bbox_exact(xywh):
    rng = np.random.RandomState(2)
    dist = rng.uniform(0, 15, (3, 64, 4)).astype(np.float32)
    pts = rng.uniform(0, 8, (64, 2)).astype(np.float32)
    got = tboxes.dist2bbox(torch.from_numpy(dist), torch.from_numpy(pts), xywh=xywh).numpy()
    ref = np.asarray(jboxes.dist2bbox(jnp.asarray(dist), jnp.asarray(pts), xywh=xywh))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("img_hw", [(640, 640), (96, 160)])
def test_anchors_exact(img_hw):
    shapes = tanchors.feat_shapes_for(img_hw, (8.0, 16.0, 32.0))
    assert shapes == janchors.feat_shapes_for(img_hw, (8.0, 16.0, 32.0))
    pts, strides = tanchors.make_anchors(shapes, 0.5)
    jpts, jstrides = janchors.make_anchors(shapes, 0.5)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(jstrides))
    assert pts.shape[0] == sum(h * w for h, w, _ in shapes)


def test_dfl_expectation_matches_jax():
    logits = np.random.RandomState(3).normal(0, 3, (2, 50, 64)).astype(np.float32)
    got = dfl_expectation(torch.from_numpy(logits), 16).numpy()
    ref = np.asarray(jax_dfl(jnp.asarray(logits), 16))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_upsample2x_exact():
    """The port's blocks run NCHW inside; the JAX function takes NHWC."""
    x = np.random.RandomState(4).rand(2, 5, 6, 3).astype(np.float32)  # NHWC
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_upsample2x(jnp.asarray(x))))
