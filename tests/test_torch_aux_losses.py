"""The port's crater auxiliary losses (``losses/crater_aux.py``) and legacy
loss (``losses/legacy_loss.py``) against the JAX functions: each loss's
value and its gradient (autograd against ``jax.grad``) on
``tests/test_aux_losses.py``'s kinds of input, degenerate ones included
(equal and touching boxes, logits at exactly 0, square boxes, a mask too
small to fit).

Stated tolerances (f32 on both sides): values ``rtol = 1e-5`` (the JAX
tests' own parity tolerance against the reference); gradients within
``1e-5 * max|g_ref|`` per argument (sums in another order; a wrong
branch at a tie moves a gradient by half its size); integer targets
exact. A comparison's gradient (the coverage penalty, the mask
thresholds) is zero in both, and finite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.losses import crater_aux as J
from yolo_scratch_tpu.losses import legacy_loss as JL
from yolo_scratch_tpu_torch.losses import crater_aux as T
from yolo_scratch_tpu_torch.losses import legacy_loss as TL


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(jfn, tfn, args, argnums, kwargs=None, what=""):
    """Value and gradients w.r.t. ``args[i]`` for i in ``argnums``."""
    kwargs = kwargs or {}
    jargs = [jnp.asarray(a) for a in args]
    ref, jgrads = jax.value_and_grad(lambda *a: jfn(*a, **kwargs), argnums=argnums)(*jargs)
    targs = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(args)]
    got = tfn(*targs, **kwargs)
    # an argument the loss reaches through no gradient path (the ellipse's
    # thresholded mask) gets None: a zero gradient, as jax.grad's
    tgrads = [torch.zeros_like(targs[i]) if g is None else g for i, g in zip(
        argnums, torch.autograd.grad(got, [targs[i] for i in argnums], allow_unused=True))]
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, err_msg=what)
    for i, g, r in zip(argnums, tgrads, jgrads):
        r = np.asarray(r)
        assert np.isfinite(g.numpy()).all(), (what, i)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-30),
                                   err_msg=f"{what} grad {i}")
    return float(got), [g.numpy() for g in tgrads]


def _rand_boxes(seed, n=16):
    rng = np.random.RandomState(seed)
    c = rng.rand(n, 2) * 0.6 + 0.2
    wh = rng.rand(n, 2) * 0.2 + 0.05
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_center_weighted_ciou(seed, weighted):
    pred, tgt = _rand_boxes(seed), _rand_boxes(seed + 100)
    pred[3] = tgt[3]  # equal boxes: IoU 1, rho 0
    w4 = tgt[4, 2] - tgt[4, 0]
    pred[4] = tgt[4] + np.float32([w4, 0, w4, 0])  # touching: the overlap's clip at 0
    args = [pred, tgt] + ([(np.arange(16) % 3 == 0).astype(np.float32)] if weighted else [])
    fn = (lambda p, t, w: J.center_weighted_ciou_loss(p, t, weights=w)) if weighted \
        else J.center_weighted_ciou_loss
    tfn = (lambda p, t, w: T.center_weighted_ciou_loss(p, t, weights=w)) if weighted \
        else T.center_weighted_ciou_loss
    _check(fn, tfn, args, (0, 1), what="ciou")


def test_objectness_and_class():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 8, 8).astype(np.float32)
    logits[0, :2] = 0.0  # |x| and the clip at their kinks
    target = rng.choice([-1.0, 0.0, 1.0], size=(2, 8, 8)).astype(np.float32)
    _check(J.objectness_loss, T.objectness_loss, [logits, target], (0,), what="obj")
    _check(J.objectness_loss, T.objectness_loss, [logits, np.full_like(target, -1.0)], (0,),
           what="obj all ignored")
    cl = rng.randn(2, 8, 8, 5).astype(np.float32)
    tc = rng.randint(-1, 5, (2, 8, 8)).astype(np.int32)
    _check(J.classification_loss, T.classification_loss, [cl, tc], (0,), what="cls")
    vm = rng.rand(2, 8, 8) > 0.5
    _check(J.classification_loss, T.classification_loss, [cl, tc, vm], (0,), what="cls masked")


def test_angular_coverage():
    B, H, W = 2, 24, 24
    mask = np.zeros((B, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    mask[0][(xx - 11.3) ** 2 + (yy - 12.4) ** 2 < 64] = 0.8
    mask[1][((xx - 11.3) ** 2 + (yy - 12.4) ** 2 < 64) & (xx > 12)] = 0.8
    centers = np.asarray([[11.3 / W, 12.4 / H], [11.3 / W, 12.4 / H]], np.float32)
    val, (g,) = _check(J.angular_coverage_loss, T.angular_coverage_loss, [mask, centers], (0,),
                       what="coverage")
    assert val > 0 and (g == 0).all()
    _check(J.angular_coverage_loss, T.angular_coverage_loss,
           [mask[..., None], centers, np.array([True, False])], (0,), what="coverage valid")


def _disk_masks(B=2, H=32, W=32):
    mask = np.zeros((B, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    mask[0][(xx - 16) ** 2 + (yy - 14) ** 2 < 81] = 1.0
    mask[1][(xx - 10) ** 2 / 64 + (yy - 20) ** 2 / 25 < 1] = 1.0
    return mask


@pytest.mark.parametrize("use_dice", [True, False])
def test_rim_weighted_mask(use_dice):
    rng = np.random.RandomState(1)
    mask = _disk_masks()
    logits = rng.randn(*mask.shape).astype(np.float32)
    logits[0, 0] = 0.0
    _check(J.rim_weighted_mask_loss, T.rim_weighted_mask_loss, [logits, mask], (0,),
           kwargs=dict(use_dice=use_dice), what="rim")
    _check(J.rim_weighted_mask_loss, T.rim_weighted_mask_loss,
           [logits[..., None], mask[..., None]], (0,), kwargs=dict(rim_kernel=5), what="rim k5")


def test_ellipse_consistency():
    H = W = 48
    yy, xx = np.mgrid[0:H, 0:W]
    masks = np.stack([
        (((xx - 24.0) / 12) ** 2 + ((yy - 20.0) / 6) ** 2 < 1),
        (((xx - 20.0) / 8) ** 2 + ((yy - 26.0) / 8) ** 2 < 1),  # a disk: angle 0 branch
        (xx - 5) ** 2 + (yy - 5) ** 2 < 2,                        # too few pixels: invalid
    ]).astype(np.float32)
    # box centres off the mask centroids: at a centroid the centre term's
    # slope (mcx - bcx) / sqrt(... + 1e-12) reads the moments' f32 rounding
    # (1e-6 px apart in the two frameworks' sums) as O(1)
    bbox = np.asarray([[24.3 / W, 19.6 / H, 24 / W, 12 / H], [0.4, 0.55, 0.3, 0.3],
                       [0.1, 0.1, 0.05, 0.05]], np.float32)  # square boxes: max/min ties
    ref = J.mask_to_ellipse(jnp.asarray(masks))
    got = T.mask_to_ellipse(torch.from_numpy(masks))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy().astype(np.float32), np.asarray(r, np.float32),
                                   rtol=1e-5, atol=1e-5)
    _, (g_mask, g_box) = _check(J.ellipse_consistency_loss, T.ellipse_consistency_loss,
                                [masks, bbox], (0, 1), what="ellipse")
    assert (g_mask == 0).all() and (g_box != 0).any()


def _legacy_inputs(seed, B=2, nc=5, grids=((8, 8), (4, 4), (2, 2), (1, 1))):
    rng = np.random.RandomState(seed)
    preds = [{"bbox": rng.randn(B, h, w, 4).astype(np.float32),
              "objectness": rng.randn(B, h, w, 1).astype(np.float32),
              "classes": rng.randn(B, h, w, nc).astype(np.float32)} for h, w in grids]
    G = 5
    c = rng.rand(B, G, 2) * 0.8 + 0.1
    wh = rng.rand(B, G, 2) * 0.3 + 0.005
    gb = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    gb[0, 1] = gb[0, 0]  # two GTs in one cell: the later one wins
    gl = rng.randint(0, nc, (B, G)).astype(np.int32)
    gm = rng.rand(B, G) > 0.3
    gm[0, :2] = True
    return preds, gl, gb, gm, list(grids)


def test_build_legacy_targets_exact():
    _, gl, gb, gm, grids = _legacy_inputs(0)
    ref = JL.build_legacy_targets(jnp.asarray(gl), jnp.asarray(gb), jnp.asarray(gm), grids)
    got = TL.build_legacy_targets(torch.from_numpy(gl), torch.from_numpy(gb),
                                  torch.from_numpy(gm), grids)
    for g, r in zip(got, ref):
        for k in ("objectness", "classes", "bbox"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]), err_msg=k)
    assert (got[0]["objectness"] > 0).sum() >= 2


def test_legacy_yolo_loss_value_and_grads():
    preds, gl, gb, gm, grids = _legacy_inputs(1)
    tgt_j = JL.build_legacy_targets(jnp.asarray(gl), jnp.asarray(gb), jnp.asarray(gm), grids)
    tgt_t = TL.build_legacy_targets(torch.from_numpy(gl), torch.from_numpy(gb),
                                    torch.from_numpy(gm), grids)
    ref, jg = jax.jit(jax.value_and_grad(lambda p: JL.legacy_yolo_loss(p, tgt_j)["total_loss"]))(
        jax.tree_util.tree_map(jnp.asarray, preds))
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()} for p in preds]
    out = TL.legacy_yolo_loss(tp, tgt_t)
    ref_all = jax.jit(JL.legacy_yolo_loss)(jax.tree_util.tree_map(jnp.asarray, preds), tgt_j)
    for k in ("total_loss", "bbox_loss", "objectness_loss", "class_loss"):
        np.testing.assert_allclose(float(out[k]), float(ref_all[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(out["total_loss"]), float(ref), rtol=1e-5)
    out["total_loss"].backward()
    for p, r in zip(tp, jg):
        for k in p:
            rr = np.asarray(r[k])
            np.testing.assert_allclose(p[k].grad.numpy(), rr, rtol=0,
                                       atol=1e-5 * np.abs(rr).max(), err_msg=k)
