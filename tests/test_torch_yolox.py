"""Port YOLOX (``yolo_scratch_tpu_torch/models/yolox.py``,
``losses/simota.py``, the weight bridge's YOLOX rule, ``nn/fuse.py`` on
YOLOX) vs the JAX package, on the CPU at 64 px.

Stated tolerances:

* maps, eval and train mode: ``1e-4 * max|ref|`` per level
  (``test_torch_model.py``'s f32 tolerance: sums in another order); BN
  running statistics after a train-mode forward: means within 1e-5, variances
  rtol 1e-4 (``chip_smoke.py``'s card-vs-CPU limits; measured 3.5e-5 on the
  2x2 P5 maps, where a batch of two gives 8 samples a channel);
* ``yolox_decode`` / ``yolox_eval_decode`` on the same maps: ``rtol 1e-6``
  on boxes and scores (``exp`` and ``sigmoid`` may round 1 ulp apart);
* the folded model against the unfolded one: ``1e-4 * max|ref|``;
* SimOTA: ``fg_mask``, ``matched_gt`` exact and ``matched_iou`` exact over
  adversarial seeds (GTs that share anchors, a duplicated GT, padded GT
  rows, an image with no GT, equal predictions on every anchor, so that
  costs tie exactly);
* the YOLOX loss: every term and ``num_fg`` ``rtol 1e-4``, ``use_l1`` on
  and off; its gradient w.r.t. the maps within ``1e-4 * max|ref|``
  (``test_torch_losses.py``'s scheme);
* the straight-through wh cap: the forward exactly the capped one, every
  gradient finite, the saturated logit's gradient non-zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import perturbed_variables
from yolo_scratch_tpu.losses import simota as JS
from yolo_scratch_tpu.models import yolox as JX
from yolo_scratch_tpu.ops.anchors import make_anchors as jax_anchors
from yolo_scratch_tpu_torch.losses import simota as TS
from yolo_scratch_tpu_torch.models import yolox as TX
from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

IMGSZ, NC = 64, 5
STRIDES = (8.0, 16.0, 32.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, ch, B=2):
    return np.random.RandomState(seed).rand(B, IMGSZ, IMGSZ, ch).astype(np.float32)


_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def jax_variables(state_dict):
    """A port YOLOX ``state_dict`` as a flax variable tree (the bridge's
    inverse; ``jm.init`` compiles for ~20 s on the CPU, this takes none)."""
    out = {"params": {}, "batch_stats": {}}
    for k, t in state_dict.items():
        *path, leaf = k.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().numpy().copy()  # JAX may alias a numpy buffer; torch writes BN's
        if path[-1] == "bn":
            col, leaf = _BN[leaf]
        else:
            col, leaf = "params", {"weight": "kernel", "bias": "bias"}[leaf]
            a = a.transpose(2, 3, 1, 0) if leaf == "kernel" else a
        node = out[col]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


@pytest.fixture(scope="module", params=[1, 3], ids=["ch1", "ch3"])
def pair(request):
    """(JAX model, perturbed variables, port model with those weights, ch)."""
    ch = request.param
    jm = JX.YOLOXModel.from_scale("nano", nc=NC)
    v = perturbed_variables(jax_variables(TX.build_yolox("nano", nc=NC, ch=ch).state_dict()),
                            seed=ch)
    tm = TX.build_yolox("nano", nc=NC, ch=ch)
    tm.load_state_dict(state_dict_from_jax(v))
    return jm, v, tm, ch


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("scale", ["nano", "tiny", "s"])
def test_bridge_covers_every_leaf_and_arch_reads_back(scale):
    """Every JAX leaf lands on exactly one port key and none is left over;
    ``yolox_arch_from_params`` reads (ch, nc, depth, width) as the JAX one
    does. Shapes only (``jax.eval_shape``)."""
    jm = JX.YOLOXModel.from_scale(scale, nc=7)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = state_dict_from_jax(v)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    real = [k for k in sd if not k.endswith("num_batches_tracked")]
    assert len(real) == n_leaves == len(set(real))
    model = TX.build_yolox(scale, nc=7, ch=3)
    want = model.state_dict()
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in sd)
    arch = JX.yolox_arch_from_params(v["params"])
    assert TX.yolox_arch_from_params(sd) == TX.yolox_arch_from_params(want) == arch
    assert arch[:2] == (3, 7) and arch[3] == TX.SCALES[scale][1]


def test_forward_eval_matches_jax(pair):
    jm, v, tm, ch = pair
    x = _images(0, ch)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 8, 8, 10), (2, 4, 4, 10), (2, 2, 2, 10)]
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_forward_train_matches_jax_bn_statistics_too(pair):
    jm, v, tm, ch = pair
    x = _images(1, ch)
    ref, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    m = TX.build_yolox("nano", nc=NC, ch=ch)
    m.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = m.train()(torch.from_numpy(x))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    stats = state_dict_from_jax({"params": v["params"], "batch_stats": upd["batch_stats"]})
    sd = m.state_dict()
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(x, torch.nn.BatchNorm2d) for x in m.modules())
    errs = {"running_mean": 0.0, "running_var": 0.0}
    for k in keys:
        kind = k.rsplit(".", 1)[1]
        d = np.abs(sd[k].numpy() - stats[k].numpy())
        errs[kind] = max(errs[kind], float((d / np.abs(stats[k].numpy()) if kind ==
                                            "running_var" else d).max()))
    assert errs["running_mean"] <= 1e-5 and errs["running_var"] <= 1e-4, errs


def test_decodes_match_jax(pair):
    jm, v, tm, ch = pair
    with torch.no_grad():
        maps = [m.contiguous() for m in tm.eval()(torch.from_numpy(_images(2, ch)))]
    jmaps = [jnp.asarray(m.numpy()) for m in maps]
    for xywh in (False, True):
        np.testing.assert_allclose(TX.yolox_decode(maps, NC, STRIDES, xywh=xywh).numpy(),
                                   np.asarray(JX.yolox_decode(jmaps, NC, STRIDES, xywh=xywh)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TX.yolox_eval_decode(maps, NC, STRIDES).numpy(),
                               np.asarray(JX.yolox_eval_decode(jmaps, NC, STRIDES)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tm.decode(maps).numpy(),
                                  TX.yolox_decode(maps, NC, STRIDES).numpy())


def test_decode_geometry():
    """A raw reg of zeros decodes to a stride-sized box at the cell corner
    (``tests/test_yolox.py::test_yolox_decode_geometry``); an inf wh logit
    decodes to the capped, finite box."""
    outs = [torch.zeros(1, 4, 4, 5 + 2)]
    dec = TX.yolox_decode(outs, 2, [8.0])
    np.testing.assert_allclose(dec[0, 0, :4].numpy(), [-4, -4, 4, 4], atol=1e-5)
    np.testing.assert_allclose(dec[0, 1, :4].numpy(), [4, -4, 12, 4], atol=1e-5)
    outs[0][0, 0, 0, 2] = float("inf")
    assert bool(torch.isfinite(TX.yolox_decode(outs, 2, [8.0])).all())


def test_folded_model_equals_unfolded(pair):
    _, _, tm, ch = pair
    x = torch.from_numpy(_images(3, ch))
    folded = fuse_conv_bn(tm.eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    with torch.no_grad():
        for g, r in zip(folded(x), tm(x)):
            _close(g.numpy(), r.numpy())


def test_focus_concatenates_tl_bl_tr_br():
    """The NCHW Focus stacks the NHWC model's [tl, bl, tr, br] on channels."""
    x = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(1, 2, 4, 4)
    seen = []
    focus = TX.Focus(2, 8)
    focus.conv.register_forward_hook(lambda m, i, o: seen.append(i[0]))
    focus(x)
    nhwc = np.asarray(x.permute(0, 2, 3, 1))
    want = np.concatenate([nhwc[:, ::2, ::2], nhwc[:, 1::2, ::2], nhwc[:, ::2, 1::2],
                           nhwc[:, 1::2, 1::2]], -1)
    np.testing.assert_array_equal(seen[0].permute(0, 2, 3, 1).numpy(), want)


def test_s_init_logits_bounded():
    """The prediction convs use torch's Conv2d default init (fan_in) and
    the prior bias: reg/obj logits O(1), cls near -4.6 at init
    (``tests/test_yolox.py::test_yolox_s_init_logits_bounded``)."""
    model = TX.build_yolox("s", nc=80, seed=0)
    x = torch.rand(2, 160, 160, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        outs = model.train()(x)
    flat = torch.cat([o.reshape(2, -1, 85) for o in outs], 1)
    assert float(flat[..., :5].abs().max()) < 8.0
    assert float(flat[..., 5:].abs().max()) < 12.0
    prior = -np.log(0.99 / 0.01)
    for i in range(3):
        assert torch.allclose(getattr(model.head, f"cls_pred_{i}").bias,
                              torch.tensor(prior, dtype=torch.float32))
        assert float(getattr(model.head, f"reg_pred_{i}").bias.detach().abs().max()) == 0.0
    # seeded: the same seed gives the same weights (the forward above moved
    # only the BN statistics)
    again = dict(TX.build_yolox("s", nc=80, seed=0).named_parameters())
    assert all(torch.equal(p, again[k]) for k, p in model.named_parameters())


# ------------------------------------------------------------------- SimOTA

def simota_case(seed):
    """Raw maps and a GT batch of 4 images: random GTs; GTs sharing anchors
    plus a duplicated GT; an image with no GT; and (seed 2) equal
    predictions on every anchor, so that costs tie."""
    rng = np.random.RandomState(seed)
    B, G = 4, 6
    maps = [rng.randn(B, IMGSZ // int(s), IMGSZ // int(s), 5 + NC).astype(np.float32)
            for s in STRIDES]
    if seed == 2:
        for m in maps:
            m[...] = m[:1, :1, :1, :]
    gb = np.zeros((B, G, 4), np.float32)
    gl = np.zeros((B, G), np.int32)
    gm = np.zeros((B, G), bool)
    n = rng.randint(1, G)
    c = rng.uniform(0.15, 0.85, (n, 2))
    wh = rng.uniform(0.05, 0.5, (n, 2))
    gb[0, :n] = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
    gl[0, :n], gm[0, :n] = rng.randint(0, NC, n), True
    # image 1: three GTs on one spot (two identical), one far away; a padded row between
    gb[1, :5] = [[0.30, 0.30, 0.55, 0.55], [0.32, 0.28, 0.52, 0.60],
                 [0.30, 0.30, 0.55, 0.55], [0.0, 0.0, 0.0, 0.0], [0.7, 0.7, 0.95, 0.9]]
    gl[1, :5], gm[1, :5] = [1, 2, 3, 0, 4], [True, True, True, False, True]
    # image 2: a tiny GT inside one cell and a large one
    gb[2, :2] = [[0.51, 0.51, 0.53, 0.53], [0.05, 0.1, 0.95, 0.9]]
    gl[2, :2], gm[2, :2] = [0, 3], True
    return maps, gb, gl, gm  # image 3: no GT


@jax.jit
def _jax_simota(pb, obj, cls, ap, st, gt_px, gl, gm):
    return jax.vmap(lambda p, o, c, g, lab, m: JS.simota_assign(p, o, c, ap, st, g, lab, m))(
        pb, obj, cls, gt_px, gl, gm)


def _jax_assign(maps, gb, gm, gl):
    """The JAX ``yolox_loss``'s assignment of these maps, vmapped."""
    B = maps[0].shape[0]
    flat = np.concatenate([m.reshape(B, -1, 5 + NC) for m in maps], 1)
    ap, st = jax_anchors([(m.shape[1], m.shape[2], s) for m, s in zip(maps, STRIDES)], 0.0)
    xy = (flat[..., :2] + ap[None]) * st[None]
    wh = jnp.exp(jnp.clip(flat[..., 2:4], -20.0, 20.0)) * st[None]
    pb = jnp.concatenate([xy - wh / 2, xy + wh / 2], -1)
    gt_px = gb * np.float32(IMGSZ) * gm[..., None]
    res = _jax_simota(pb, flat[..., 4], flat[..., 5:], ap, st[:, 0], gt_px, gl, gm)
    args = tuple(torch.from_numpy(np.array(a)) for a in (
        pb, flat[..., 4], flat[..., 5:], ap, st[:, 0], gt_px, gl, gm))
    return res, args


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_simota_assign_matches_jax(seed):
    maps, gb, gl, gm = simota_case(seed)
    ref, args = _jax_assign(maps, gb, gm, gl)
    got = TS.simota_assign(*args)
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(ref.matched_gt))
    np.testing.assert_array_equal(got.matched_iou.numpy(), np.asarray(ref.matched_iou))
    fg = got.fg_mask.numpy()
    assert fg[:3].any(axis=1).all() and not fg[3].any()  # the no-GT image stays bg
    assert not (got.matched_gt.numpy()[1][fg[1]] == 3).any()  # never the padded row


def test_simota_chunks_agree_with_one_pass(monkeypatch):
    """The loss assigns a chunk of images at a time (bounded memory): the
    result is the one-pass result."""
    maps, gb, gl, gm = simota_case(1)
    _, args = _jax_assign(maps, gb, gm, gl)
    whole = TS.simota_assign(*args)
    monkeypatch.setattr(TS, "ASSIGN_CHUNK_ELEMS", 1)  # one image a chunk
    parts = TS._assign_chunked(*args)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@functools.partial(jax.jit, static_argnums=4)
def _jax_loss_and_grad(maps, gl, gb, gm, use_l1):
    cfg = JS.YOLOXLossConfig(nc=NC, use_l1=use_l1)
    return jax.value_and_grad(lambda ms: JS.yolox_loss(ms, gl, gb, gm, cfg), has_aux=True)(maps)


@pytest.mark.parametrize("use_l1", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yolox_loss_matches_jax(seed, use_l1):
    maps, gb, gl, gm = simota_case(seed)
    (ref_total, ref_aux), ref_grads = _jax_loss_and_grad(maps, gl, gb, gm, use_l1)
    tmaps = [torch.tensor(m, requires_grad=True) for m in maps]
    total, aux = TS.yolox_loss(tmaps, torch.from_numpy(gl), torch.from_numpy(gb),
                               torch.from_numpy(gm), TS.YOLOXLossConfig(nc=NC, use_l1=use_l1))
    total.backward()
    assert sorted(aux) == sorted(ref_aux) == ["cls_loss", "iou_loss", "l1_loss", "num_fg",
                                              "obj_loss"]
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-4)
    for k in ref_aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=1e-4, err_msg=k)
    assert (float(aux["l1_loss"]) > 0) == use_l1 and float(aux["num_fg"]) > 0
    for t, r in zip(tmaps, ref_grads):
        _close(t.grad.numpy(), r)


def test_wh_cap_nan_safe_and_gradient_preserving():
    """(a) the forward value is exactly the capped one for any input, inf
    included; (b) every gradient is finite; (c) a saturated finite logit
    keeps a non-zero gradient; each as in the JAX package
    (``tests/test_yolox.py::test_yolox_wh_cap_nan_safe_and_gradient_preserving``)."""
    B, S, nc = 1, 8, 5
    cfg = TS.YOLOXLossConfig(nc=nc, strides=(8.0,))
    gl = torch.zeros(B, 2, dtype=torch.int32)
    gb = torch.zeros(B, 2, 4)
    gm = torch.zeros(B, 2, dtype=torch.bool)
    gb[0, 0] = torch.tensor([0.40, 0.40, 0.72, 0.72])
    gm[0, 0] = True
    base = torch.zeros(B, S, S, 5 + nc)
    base[..., 5:] = -4.0
    div = base.clone()
    div[..., 2] = 1e9
    div[0, 3, 3, 3] = float("inf")
    capped = div.clone()
    capped[..., 2] = 20.0
    capped[0, 3, 3, 3] = 20.0

    x = div.clone().requires_grad_(True)
    total, _ = TS.yolox_loss([x], gl, gb, gm, cfg)
    total.backward()
    assert bool(torch.isfinite(total)) and bool(torch.isfinite(x.grad).all())
    assert float(total) == float(TS.yolox_loss([capped], gl, gb, gm, cfg)[0])
    assert float(x.grad[..., 2].abs().max()) > 0.0
    assert float(x.grad[0, 3, 3, 3]) == 0.0  # inf: no pass-through, no NaN


def test_train_step_survives_divergent_wh_logits():
    """With every reg_pred scaled 2000x (wh logits far past the cap) one
    clip + AdamW step keeps the loss and the parameters finite
    (``tests/test_yolox.py::test_yolox_train_step_survives_divergent_wh_logits``)."""
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.train.optim import cosine_epoch_schedule, make_optimizer
    from yolo_scratch_tpu_torch.train.state import create_train_state
    from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, yolox_loss_adapter

    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=64, channels=3, num_classes=5),
                             batch_size=4, max_gt=8, prefetch=0)))
    model = TX.build_yolox("nano", nc=5, ch=3)
    with torch.no_grad():
        for m in [getattr(model.head, f"reg_pred_{i}") for i in range(3)]:
            m.weight.mul_(2000.0)
            m.bias.mul_(2000.0)
    state = create_train_state(model, make_optimizer(cosine_epoch_schedule(1e-3, 2, 1, 1),
                                                     5e-4, 10.0))
    step = build_train_step_custom(model, yolox_loss_adapter(TS.YOLOXLossConfig(nc=5)))
    state, metrics = step(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
