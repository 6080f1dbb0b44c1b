"""The blocked top-k (``ops/decode.py::topk_scores(blocked=kb)``, the infer
CLI's ``--blocked-topk``) and the tiled NMS (``ops/nms.py::batched_nms_tiled``,
``nms_impl="tiled"``) against the JAX functions on the same inputs.

Stated tolerances: selected values and indices exact (f32 and bf16, ties
included); keep sets exact, against JAX's ``batched_nms_tiled`` and against
the port's other sweeps. Detections through ``postprocess_from_feats`` /
``postprocess`` at ``tests/test_torch_decode.py``'s tolerances (labels and
valid exact, scores 2 ulp, normalised boxes 2e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_decode import IMG, NC, STRIDES, assert_detections_match, make_feats
from tests.test_torch_nms import _boxes, _t
from yolo_scratch_tpu.nn.modules import detect_decode as jax_detect_decode
from yolo_scratch_tpu.ops.decode import postprocess as jax_postprocess
from yolo_scratch_tpu.ops.decode import postprocess_from_feats as jax_from_feats
from yolo_scratch_tpu.ops.decode import topk_scores as jax_topk
from yolo_scratch_tpu.ops.nms import batched_nms_tiled as jax_tiled
from yolo_scratch_tpu_torch.host import PredictorConfig
from yolo_scratch_tpu_torch.infer import Predictor
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.ops import nms_kernels as tk
from yolo_scratch_tpu_torch.ops.decode import postprocess, postprocess_from_feats, topk_scores
from yolo_scratch_tpu_torch.ops.nms import batched_nms_tiled, nms

# ---------------------------------------------------------------- blocked top-k


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scores(seed, B, A, dtype, crowd):
    """(B, A) scores with a -inf share (the conf gate); ``crowd`` puts the
    ``crowd`` highest scores of image 0 into one 128-lane block."""
    rng = np.random.RandomState(seed)
    s = rng.normal(0, 2, (B, A)).astype(np.float32)
    if dtype == "bfloat16":
        s = np.round(s * 4) / 4  # few levels: heavy ties
    s[rng.rand(B, A) < 0.2] = -np.inf
    if crowd:
        s[0, 256:256 + crowd] = 50.0 + np.arange(crowd, dtype=np.float32)[::-1] / 8
    j = jnp.asarray(s).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("A,k,kb,crowd", [(8400, 512, 32, 100), (8400, 512, 32, 0),
                                          (1000, 300, 16, 0), (84, 84, 32, 0),
                                          (300, 700, 8, 0)])
def test_blocked_topk_matches_jax(dtype, A, k, kb, crowd):
    """Values and indices exact: A a whole number of blocks or not, k above
    the survivor count (padded with -inf at index 0), and a crowded block
    holding more than kb of the global top-k, where blocked differs from
    exact (and equals it where no block is crowded)."""
    js, ts = _scores(A + kb, 3, A, dtype, crowd)
    ref_v, ref_i = jax.jit(jax_topk, static_argnums=(1, 2))(js, k, kb)
    got_v, got_i = topk_scores(ts, k, blocked=kb)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(ref_v.astype(jnp.float32)))
    exact_v, exact_i = topk_scores(ts, k)
    survivors = -(-A // 128) * kb
    if crowd:  # blocked keeps kb of the crowd: the selection differs from exact
        assert not torch.equal(got_i[0], exact_i[0])
        assert int(((got_i[0] >= 256) & (got_i[0] < 256 + crowd)).sum()) == kb
    elif survivors >= min(k, A):
        assert torch.equal(got_i, exact_i)
    else:  # fewer survivors than k: the tail is padding
        assert (got_v[:, survivors:].float() == float("-inf")).all()
        assert (got_i[:, survivors:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_topk_orders_signed_zeros_as_xla(dtype):
    """XLA's ``top_k`` compares in the floats' total order: -0.0 below
    +0.0, where ``torch.sort`` calls them equal. The exact selection
    follows XLA (the bf16 case of the blocked test found it)."""
    s = np.array([[-0.0, 0.0, 1.0, -0.0, 0.0, -1.0, -np.inf, 0.0]], np.float32)
    j = jnp.asarray(s).astype(getattr(jnp, dtype))
    t = torch.from_numpy(s).to(getattr(torch, dtype))
    ref_v, ref_i = jax.lax.top_k(j, 8)
    got_v, got_i = topk_scores(t, 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert got_i.tolist() == [[2, 1, 4, 7, 0, 3, 5, 6]]
    np.testing.assert_array_equal(np.signbit(got_v.float().numpy()),
                                  np.signbit(np.asarray(ref_v.astype(jnp.float32))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_from_feats_matches_jax(dtype):
    """``postprocess_from_feats(blocked_topk=kb)`` on the same raw maps
    (128 px: 336 anchors, 3 blocks, k=128 above 3 x kb survivors)."""
    jf, tf = make_feats(5, dtype=dtype)
    kw = dict(nc=NC, strides=STRIDES, img_size=IMG, conf_threshold=0.25, iou_threshold=0.45,
              max_det=40, pre_nms_topk=128, blocked_topk=24)
    ref = jax_from_feats(jf, nms_impl="xla", **kw)
    got = postprocess_from_feats(tf, nms_impl="kernel", **kw)
    assert_detections_match(got, ref)


def test_predictor_blocked_topk_option():
    """``PredictorConfig.blocked_topk`` reaches the selection: blocked with
    kb = 128 (every lane survives) equals exact; a kb below the crowding
    changes the detections."""
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=3)
    x = np.random.RandomState(4).randint(0, 256, (2, 64, 64, 1), dtype=np.uint8)
    out = {kb: Predictor(model, PredictorConfig(img_size=64, batch_size=2, conf_threshold=0.0,
                                                bf16=False, blocked_topk=kb),
                         device="cpu").predict_batch(x) for kb in (0, 128, 4)}
    assert torch.equal(out[0], out[128]) and not torch.equal(out[0], out[4])


# ---------------------------------------------------------------- tiled NMS


def _tie_boxes(rng, B, n, iou):
    """Dense random boxes with planted triples at the head: a 20x20 box, the
    same cut to height 20*iou (IoU == threshold in f32) and one half a
    pixel taller (``test_torch_nms.py``'s ties)."""
    t = 12
    boxes = _boxes(rng, (B, n), 160.0, 40.0, 5.0)
    xy = rng.randint(0, 160, (B, t, 1, 2)).astype(np.float32)
    h = np.array([20.0, 20.0 * iou, 20.0 * iou + 0.5], np.float32)
    planted = np.concatenate([np.broadcast_to(xy, (B, t, 3, 2)),
                              xy + np.stack([np.full(3, 20.0, np.float32), h], -1)], -1)
    boxes[:, : 3 * t] = planted.reshape(B, 3 * t, 4)
    scores = rng.rand(B, n).astype(np.float32)
    scores[:, : 3 * t] = np.linspace(2.0, 1.5, 3 * t, dtype=np.float32)  # pivots first
    return boxes, scores


TILED_CASES = [  # (seed, B, n, iou, max_det, class_aware, tile)
    (0, 2, 200, 0.45, 300, False, 128),  # n not a multiple of the tile
    (1, 3, 256, 0.5, 300, True, 128),    # class-aware
    (2, 2, 300, 0.7, 25, False, 64),     # max_det binding, a smaller tile
    (3, 1, 50, 0.45, 10, True, 128),     # one partial tile
]


@pytest.mark.parametrize("seed,B,n,iou,max_det,class_aware,tile", TILED_CASES)
def test_tiled_matches_jax_and_the_other_sweeps(seed, B, n, iou, max_det, class_aware, tile):
    rng = np.random.RandomState(seed)
    boxes, scores = _tie_boxes(rng, B, n, iou)
    valid = rng.rand(B, n) > 0.1
    labels = rng.randint(0, 3, (B, n)).astype(np.int32)
    kw = dict(iou_threshold=iou, max_det=max_det, class_aware=class_aware)
    ref = np.asarray(jax_tiled(boxes, scores, valid, class_ids=labels, tile=tile, **kw))
    got = batched_nms_tiled(_t(boxes), _t(scores), _t(valid), class_ids=_t(labels), tile=tile,
                            **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < got.sum() < valid.sum()
    if max_det < 300:
        assert int(got.sum(1).max()) == max_det
    # the port's pairwise sweep and the kernels (their plain versions here)
    pair = torch.stack([nms(_t(b), _t(s), valid=_t(v), class_ids=_t(c), **kw)
                        for b, s, v, c in zip(boxes, scores, valid, labels)])
    kern = tk.nms_kernel_batched(_t(boxes), _t(scores), _t(valid), class_ids=_t(labels), **kw)
    assert torch.equal(got, pair) and torch.equal(got, kern)


@pytest.mark.parametrize("class_aware", [False, True])
def test_postprocess_tiled_matches_jax(class_aware):
    jf, tf = make_feats(6)
    decoded = jax_detect_decode(jf, NC, STRIDES, 16)
    dec_t = torch.from_numpy(np.array(decoded))
    kw = dict(img_size=IMG, conf_threshold=0.2, iou_threshold=0.45, max_det=30,
              pre_nms_topk=150, class_aware=class_aware)
    assert_detections_match(postprocess(dec_t, nms_impl="tiled", **kw),
                            jax_postprocess(decoded, nms_impl="tiled", **kw))
    kw = dict(nc=NC, strides=STRIDES, img_size=IMG, conf_threshold=0.2, iou_threshold=0.45,
              max_det=30, pre_nms_topk=150, class_aware=class_aware)
    ref = jax_from_feats(jf, nms_impl="tiled", **kw)
    got = postprocess_from_feats(tf, nms_impl="tiled", **kw)
    assert_detections_match(got, ref)
    pair = postprocess_from_feats(tf, nms_impl="pairwise", **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, pair))
