"""Port losses (yolo_scratch_tpu_torch.losses, ops.boxes) vs the JAX package
on the same numpy inputs from a seed.

Stated tolerances:

* ``bbox_iou`` plain IoU and ``bbox2dist``: exact (the same f32 operations
  in the same order). GIoU/DIoU/CIoU: ``atol = 1e-6`` (``atan`` and the
  divides of the penalty terms may round 1 ulp apart). CIoU's gradient
  with ``alpha`` held constant: ``1e-5 * max|ref|``.
* TAL (``task_aligned_assign``): ``fg_mask``, ``target_gt_idx``,
  ``target_labels`` and ``target_bboxes`` bit-exact over adversarial seeds
  (a GT with no in-box anchor, GTs that share their best anchor, IoU ties
  across anchors, padded GT rows, and a GT that force pass 2 reaches only
  through an earlier GT's forced update); ``target_scores`` ``rtol = 1e-5`` (the
  align metric's ``pow`` may round 1 ulp apart).
* v8 loss: the (box, cls, dfl) triplet and the total ``rtol = 1e-4``; the
  gradient w.r.t. the feats within ``1e-4 * max|ref|`` against
  ``jax.grad``. The fallback branch (no foreground): ``_fallback_assign``
  exact, the loss through it ``rtol = 1e-4``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.losses import v8_loss as jloss
from yolo_scratch_tpu.losses.tal import task_aligned_assign as jax_tal
from yolo_scratch_tpu.ops import boxes as jboxes
from yolo_scratch_tpu_torch.losses import v8_loss as tloss
from yolo_scratch_tpu_torch.losses.tal import task_aligned_assign
from yolo_scratch_tpu_torch.ops import boxes as tboxes
from yolo_scratch_tpu_torch.ops.anchors import make_anchors

IMG, STRIDES, NC, REG, G = 64, (8.0, 16.0, 32.0), 5, 16, 8
SHAPES = [(int(IMG // s), int(IMG // s), s) for s in STRIDES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_boxes(rng, shape, xywh):
    c = rng.uniform(0, 64, (*shape, 2))
    wh = rng.uniform(1, 40, (*shape, 2))
    b = np.concatenate([c, wh] if xywh else [c - wh / 2, c + wh / 2], -1)
    return b.astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False])
def test_bbox_iou_and_bbox2dist_match_jax(xywh):
    rng = np.random.RandomState(3)
    b1, b2 = _rand_boxes(rng, (50, 1), xywh), _rand_boxes(rng, (1, 40), xywh)
    b2[0, :7] = b1[:7, 0]  # identical pairs: IoU ~ 1, zero penalty terms
    plain = tboxes.bbox_iou(_t(b1), _t(b2), xywh=xywh).numpy()
    np.testing.assert_array_equal(plain, np.asarray(jboxes.bbox_iou(b1, b2, xywh=xywh)))
    for kind in ("GIoU", "DIoU", "CIoU"):
        got = tboxes.bbox_iou(_t(b1), _t(b2), xywh=xywh, **{kind: True}).numpy()
        ref = np.asarray(jboxes.bbox_iou(b1, b2, xywh=xywh, **{kind: True}))
        assert got.shape == ref.shape == (50, 40, 1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=kind)

    anchors = rng.uniform(0, 16, (30, 2)).astype(np.float32)
    boxes = _rand_boxes(rng, (30,), False) / 4
    np.testing.assert_array_equal(tboxes.bbox2dist(_t(anchors), _t(boxes), 15).numpy(),
                                  np.asarray(jboxes.bbox2dist(anchors, boxes, 15)))


def test_ciou_gradient_treats_alpha_as_constant():
    rng = np.random.RandomState(4)
    b1, b2 = _rand_boxes(rng, (64,), False), _rand_boxes(rng, (64,), False)
    ref = np.asarray(jax.grad(lambda a: jboxes.bbox_iou(a, b2, xywh=False, CIoU=True).sum())(b1))
    x = _t(b1).requires_grad_()
    tboxes.bbox_iou(x, _t(b2), xywh=False, CIoU=True).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------------------- TAL

_jax_tal = jax.jit(jax_tal, static_argnames=("num_classes",))


def _tal_case(seed):
    """Adversarial assigner inputs at 64 px (A = 84 anchors, G = 8), B = 2.

    Every case has a GT between anchor centres (no in-box anchor: force
    pass 1 takes its best IoU overall), a duplicated GT (two GTs share
    their best anchor: the conflict and force pass 2 decide) and a padded
    row. Odd seeds give every anchor of an image the same predicted box,
    so IoUs tie across anchors and argmax order decides. Seed ``CHAIN`` is
    :func:`_chain_case`."""
    rng = np.random.RandomState(seed)
    anchors, strides = (a.numpy() for a in make_anchors(SHAPES))
    ap = anchors * strides
    A = ap.shape[0]
    scores = rng.uniform(0.01, 0.99, (2, A, NC)).astype(np.float32)
    if seed == CHAIN:
        return (scores, *_chain_case(ap))
    lt = rng.uniform(0.5, 3.0, (2, A, 2)) * strides
    rb = rng.uniform(0.5, 3.0, (2, A, 2)) * strides
    pd = np.concatenate([ap - lt, ap + rb], -1).astype(np.float32)
    if seed % 2:
        pd[:] = pd[:, :1]
    gt = np.zeros((2, G, 4), np.float32)
    mask = np.zeros((2, G), bool)
    labels = rng.randint(0, NC, (2, G)).astype(np.int32)
    for b in range(2):
        n = rng.randint(4, G)  # rows n.. stay padded
        c = rng.uniform(8, 56, (n, 2))
        wh = rng.uniform(6, 40, (n, 2))
        gt[b, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        gt[b, 0] = [4.5 + b / 2, 4.5, 7.5, 7.5 - b / 2]  # between the centres 4 and 8
        gt[b, 2] = gt[b, 1]  # a duplicate: shares GT 1's best anchor
        mask[b, :n] = True
    return scores, pd, ap, labels, gt, mask


CHAIN = 6


def _chain_case(ap):
    """Force pass 2 must run in GT order. GT 1 holds no anchor centre, so
    force pass 1 gives it anchor x = (12, 12), which GT 2 (x its only
    anchor) wins back by IoU. In pass 2 GT 1 retakes x; only then is GT 2
    unassigned, and it is forced onto its best-IoU anchor y = (4, 4), whose
    predicted box is GT 2 itself. Every other anchor predicts a 2 px box at
    its own centre. Returns (pd, ap, labels, gt, mask) at B = 2."""
    x = int(np.flatnonzero((ap == 12).all(-1))[0])
    y = int(np.flatnonzero((ap == 4).all(-1))[0])
    pd = np.concatenate([ap - 1, ap + 1], -1)
    pd[x] = [10, 10, 15, 15]
    pd[y] = [10, 10, 14, 14]
    gt = np.zeros((G, 4), np.float32)
    gt[0] = [40, 40, 60, 60]
    gt[1] = [12.5, 12.5, 15.5, 15.5]
    gt[2] = [10, 10, 14, 14]
    mask = np.arange(G) < 3
    return (np.stack([pd, pd]).astype(np.float32), ap, np.tile(np.arange(G) % NC, (2, 1)),
            np.stack([gt, gt]), np.stack([mask, mask]))


@pytest.mark.parametrize("seed", range(CHAIN + 1))
def test_tal_matches_jax_bit_exact(seed):
    scores, pd, ap, labels, gt, mask = _tal_case(seed)
    ref = _jax_tal(scores, pd, ap, labels, gt, mask, num_classes=NC)
    got = task_aligned_assign(_t(scores), _t(pd), _t(ap), _t(labels), _t(gt), _t(mask),
                              num_classes=NC)
    fg = np.asarray(ref.fg_mask)
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(ref.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(ref.target_labels))
    np.testing.assert_array_equal(got.target_bboxes.numpy(), np.asarray(ref.target_bboxes))
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores),
                               rtol=1e-5, atol=0)
    if seed == CHAIN:  # GT 2 ended on anchor y: pass 2 saw GT 1's update
        y = int(np.flatnonzero((ap == 4).all(-1))[0])
        assert fg[:, y].all() and (got.target_gt_idx.numpy()[:, y] == 2).all()
        return
    # the inputs are what the docstring says: GT 0 holds no anchor centre,
    # and the force passes gave some anchor to it
    inside = ((ap[None] > gt[:, None, 0, :2]) & (ap[None] < gt[:, None, 0, 2:])).all(-1)
    assert not inside.any()
    assert fg.sum() > 0


# ---------------------------------------------------------------- v8 loss

CFG_J = jloss.DetectionLossConfig(nc=NC, strides=STRIDES)
CFG_T = tloss.DetectionLossConfig(nc=NC, strides=STRIDES)


def _loss_inputs(seed):
    """Raw NHWC maps (B=2, 64 px) and padded targets from SyntheticDataset."""
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset

    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1.5, (2, h, w, 4 * REG + NC)).astype(np.float32)
             for h, w, _ in SHAPES]
    batch = next(iter(Loader(SyntheticDataset(n=2, img_size=IMG, seed=seed), 2, max_gt=G,
                             prefetch=0)))
    return feats, batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"]


def _jax_total(feats, gl, gb, gm):
    return jloss.v8_detection_loss(feats, gl, gb, gm, CFG_J)


_jax_loss = jax.jit(_jax_total)
_jax_grad = jax.jit(jax.grad(lambda *a: _jax_total(*a)[0]))


def _torch_loss(feats, gl, gb, gm, grad=False):
    fs = [_t(f).requires_grad_(grad) for f in feats]
    total, items = tloss.v8_detection_loss(fs, _t(gl), _t(gb), _t(gm), CFG_T)
    if grad:
        total.backward()
    return total, items, fs


@pytest.mark.parametrize("seed", [0, 1])
def test_v8_loss_and_grad_match_jax(seed):
    feats, gl, gb, gm = _loss_inputs(seed)
    total, items, fs = _torch_loss(feats, gl, gb, gm, grad=True)
    ref_total, ref_items = _jax_loss(feats, gl, gb, gm)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=1e-4)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-4)
    assert (items.numpy() > 0).all()
    for g, r in zip(fs, _jax_grad(feats, gl, gb, gm)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.grad.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_fallback_assign_matches_jax():
    """Duplicate GTs share their best anchor: the later one wins there."""
    scores, pd, ap, labels, gt, mask = _tal_case(2)
    ref = jloss._fallback_assign(pd, labels, gt, mask, NC)
    got = tloss._fallback_assign(_t(pd), _t(labels), _t(gt), _t(mask), NC)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[3].sum() > 0


def test_v8_loss_fallback_branch_matches_jax(monkeypatch):
    """With the assigner forced to return no foreground, both packages take
    the reference's all-IoU fallback; the port selects it on the device."""
    from yolo_scratch_tpu_torch.losses import tal as ttal

    feats, gl, gb, gm = _loss_inputs(0)
    normal = _torch_loss(feats, gl, gb, gm)[1]

    def no_fg(assign, zeros):
        def fn(*args, **kw):
            r = assign(*args, **kw)
            return r._replace(fg_mask=zeros(r.fg_mask))
        return fn

    monkeypatch.setattr(jloss, "task_aligned_assign", no_fg(jloss.task_aligned_assign,
                                                            jnp.zeros_like))
    monkeypatch.setattr(tloss, "task_aligned_assign", no_fg(ttal.task_aligned_assign,
                                                            torch.zeros_like))
    total, items, _ = _torch_loss(feats, gl, gb, gm)
    # a new function object, so that jit traces the patched assigner
    ref_total, ref_items = jax.jit(lambda *a: jloss.v8_detection_loss(*a, CFG_J))(
        feats, gl, gb, gm)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=1e-4)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-4)
    assert not np.allclose(items.numpy(), normal.numpy())  # the fallback did change it
