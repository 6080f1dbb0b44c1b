"""Port decode path (yolo_scratch_tpu_torch.ops.decode) vs the JAX package
on identical inputs, in f32 and in bf16.

Stated tolerances:

* labels and valid: exact; the candidate order is exact too (a wrong tie
  order moves whole boxes, far outside the box tolerance).
* scores: at most 2 ulp. Both sides compute ``1 / (1 + exp(-x))`` in f32,
  but XLA's CPU ``exp`` and PyTorch's differ in the last bit on ~10% of
  inputs, which moves the sigmoid by 1 ulp on ~0.4% of them (2 ulp seen
  only for small scores, below any confidence threshold used here).
* boxes (normalised to [0, 1]): ``atol = 2e-6``, a few f32 ulps of the
  pixel coordinates after the DFL softmax-expectation, whose sum order
  differs between the frameworks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_scratch_tpu.nn.modules import detect_decode as jax_detect_decode
from yolo_scratch_tpu.ops.decode import postprocess as jax_postprocess
from yolo_scratch_tpu.ops.decode import postprocess_from_feats as jax_from_feats
from yolo_scratch_tpu_torch.nn.modules import detect_decode
from yolo_scratch_tpu_torch.ops.decode import postprocess, postprocess_from_feats, topk_scores

NC, REG, IMG, STRIDES = 5, 16, 128, (8.0, 16.0, 32.0)
JAX_IMPL = {"kernel": "pallas", "pairwise": "xla"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_feats(seed, B=2, dtype="float32", tie_levels=0):
    """Raw NHWC Detect maps at IMG px. ``tie_levels`` > 0 draws the class
    logits from that many integer values, so max-logits tie massively."""
    rng = np.random.RandomState(seed)
    feats = []
    for s in STRIDES:
        g = int(IMG // s)
        box = rng.normal(0.0, 2.0, (B, g, g, 4 * REG))
        if tie_levels:
            cls = rng.randint(-tie_levels, 1, (B, g, g, NC)).astype(np.float64)
        else:
            cls = rng.normal(-0.5, 2.0, (B, g, g, NC))
        feats.append(np.concatenate([box, cls], -1).astype(np.float32))
    jf = [jnp.asarray(f).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
          for f in feats]
    tf = [torch.from_numpy(np.array(f.astype(jnp.float32))).to(getattr(torch, dtype))
          for f in jf]
    return jf, tf


def assert_detections_match(got, ref):
    gb, gs, gl, gv = (t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy() for t in got)
    rb, rs, rl, rv = (np.asarray(r.astype(jnp.float32) if r.dtype == jnp.bfloat16 else r)
                      for r in ref)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_array_max_ulp(gs, rs, maxulp=2)
    np.testing.assert_allclose(gb, rb, rtol=0, atol=2e-6)
    assert rv.sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["kernel", "pairwise"])
def test_postprocess_from_feats_matches_jax(dtype, impl):
    jf, tf = make_feats(0, dtype=dtype)
    kw = dict(nc=NC, strides=STRIDES, img_size=IMG, conf_threshold=0.25,
              iou_threshold=0.45, max_det=40, pre_nms_topk=128)
    ref = jax_from_feats(jf, nms_impl=JAX_IMPL[impl], **kw)
    got = postprocess_from_feats(tf, nms_impl=impl, **kw)
    assert_detections_match(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 2])  # B=1 takes the single-image kernel
@pytest.mark.parametrize("class_aware", [False, True])
def test_postprocess_matches_jax(dtype, B, class_aware):
    jf, _ = make_feats(1, B=B, dtype=dtype)
    decoded = jax_detect_decode(jf, NC, STRIDES, REG)  # identical input to both
    dec_t = torch.from_numpy(np.array(decoded.astype(jnp.float32))).to(getattr(torch, dtype))
    kw = dict(img_size=IMG, conf_threshold=0.3, iou_threshold=0.45, max_det=30,
              pre_nms_topk=100, class_aware=class_aware)
    ref = jax_postprocess(decoded, nms_impl="pallas", **kw)
    got = postprocess(dec_t, nms_impl="kernel", **kw)
    assert_detections_match(got, ref)


def test_detect_decode_matches_jax_f32():
    jf, tf = make_feats(2)
    ref = np.asarray(jax_detect_decode(jf, NC, STRIDES, REG))
    got = detect_decode(tf, NC, STRIDES, REG).numpy()
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=0, atol=2e-6 * IMG)
    np.testing.assert_array_max_ulp(got[..., 4:], ref[..., 4:], maxulp=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selection_tie_order_matches_xla(dtype):
    """Class logits from 4 integer levels (-3..0): hundreds of anchors share each
    max-logit and the top-k boundary cuts through a tie. XLA orders equal
    keys lower index first; the port must select and order the same rows."""
    jf, tf = make_feats(3, dtype=dtype, tie_levels=3)
    kw = dict(nc=NC, strides=STRIDES, img_size=IMG, conf_threshold=0.0,
              iou_threshold=0.45, max_det=60, pre_nms_topk=96)
    ref = jax_from_feats(jf, nms_impl="pallas", **kw)
    got = postprocess_from_feats(tf, nms_impl="kernel", **kw)
    assert_detections_match(got, ref)
    logits = torch.cat([f.reshape(2, -1, NC + 4 * REG)[..., 4 * REG:] for f in tf], 1)
    assert (logits.amax(-1) == 0).sum(-1).min() > 96  # the boundary is inside a tie


def test_topk_scores_exact_only():
    """The default is the exact top-k; the blocked selection is opt-in
    (``tests/test_torch_topk_tiled.py`` holds it against JAX) and equals
    the exact one where no block holds more than kb of the top-k."""
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = topk_scores(s, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0, 3.0, 3.0]]
    bvals, bidx = topk_scores(s, 3, blocked=32)
    assert torch.equal(bidx, idx) and torch.equal(bvals, vals)


def test_cand_count_matches_jax():
    jf, tf = make_feats(4)
    kw = dict(nc=NC, strides=STRIDES, img_size=IMG, pre_nms_topk=64, with_cand_count=True)
    ref = jax_from_feats(jf, nms_impl="pallas", **kw)[-1]
    got = postprocess_from_feats(tf, nms_impl="kernel", **kw)[-1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
