"""Port device augmentation (``yolo_scratch_tpu_torch/data/augment.py``) vs
the JAX package's ``data/augment.py``, on the CPU.

torch cannot reproduce JAX's threefry streams, so every test replays the
JAX draws (the same ``jax.random.split`` calls, made here) into the port's
apply functions. Stated tolerances:

* geometry (mosaic crops and flips), boxes, labels and masks: exact;
* mixup's blended image: 1e-6 absolute (measured 6.0e-8: one multiply-add
  a pixel, rounded differently);
* HSV jitter: 1e-6 absolute (measured 4.8e-7, 6.6e-7 after mixup: the hue
  formula's divides and products differ in the last ulp); gray jitter:
  1e-6 (measured 1.8e-7, 2.4e-7 after mixup: the image mean sums in
  another order);
* ``letterbox_batch``: 1e-5 absolute, shrinking and growing (measured
  1.8e-7 and 6.0e-8: both frameworks weigh a triangle filter whose support
  scales with the shrink, renormalised at the border);
* the Beta(alpha, alpha) draw: mean and variance within 4 standard errors
  of 0.5 and 1/(4(2 alpha + 1)) over 200,000 draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_scratch_tpu.data import augment as JA
from yolo_scratch_tpu_torch.data import augment as TA

B, S, G = 4, 32, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed=0, C=3):
    """Random colour images and boxes; image 3 has no GT, the others 1..G."""
    rng = np.random.RandomState(seed)
    img = rng.rand(B, S, S, C).astype(np.float32)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.zeros((B, G), np.int32)
    mask = np.zeros((B, G), bool)
    for b in range(B - 1):
        n = rng.randint(1, G + 1)
        c = rng.uniform(0.1, 0.9, (n, 2))
        wh = rng.uniform(0.002, 0.5, (n, 2))
        boxes[b, :n] = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
        labels[b, :n] = rng.randint(0, 5, n)
        mask[b, :n] = True
    return {"img": img, "gt_bboxes": boxes, "gt_labels": labels, "gt_mask": mask,
            "sample_valid": np.ones(B, bool)}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_draws(key, n, C, cfg):
    """The draws ``JA.augment_batch(batch, key, cfg)`` makes, as port draws."""
    k_m, k_x, k_h, k_v, k_c = jax.random.split(key, 5)
    mosaic = mix = hflip = vflip = color = None
    if cfg.mosaic_p > 0:
        k_sel, k_off, k_apply = jax.random.split(k_m, 3)
        mosaic = TA.MosaicDraw(_t(jax.random.randint(k_sel, (n, 3), 0, n), torch.int64),
                               _t(jax.random.uniform(k_off, (n, 2))),
                               _t(jax.random.uniform(k_apply, (n,)) < cfg.mosaic_p))
    if cfg.mixup_p > 0:
        k_sel, k_lam, k_apply = jax.random.split(k_x, 3)
        partner = (jnp.arange(n) + jax.random.randint(k_sel, (n,), 1, n)) % n
        lam = jax.random.beta(k_lam, cfg.mixup_alpha, cfg.mixup_alpha, (n,)).astype(jnp.float32)
        mix = TA.MixupDraw(_t(partner, torch.int64), _t(lam),
                           _t(jax.random.uniform(k_apply, (n,)) < cfg.mixup_p))
    if cfg.hflip_p > 0:
        hflip = _t(jax.random.uniform(k_h, (n,)) < cfg.hflip_p)
    if cfg.vflip_p > 0:
        vflip = _t(jax.random.uniform(k_v, (n,)) < cfg.vflip_p)
    if cfg.color_p > 0:
        if C == 3:
            kh, ks, kv, kp = jax.random.split(k_c, 4)
            gains = jnp.stack([
                jax.random.uniform(kh, (n,), minval=-cfg.hsv_h, maxval=cfg.hsv_h),
                1.0 + jax.random.uniform(ks, (n,), minval=-cfg.hsv_s, maxval=cfg.hsv_s),
                1.0 + jax.random.uniform(kv, (n,), minval=-cfg.hsv_v, maxval=cfg.hsv_v)], -1)
        else:
            kb, kc, kp = jax.random.split(k_c, 3)
            bright = 1.0 + jax.random.uniform(kb, (n,), minval=-cfg.hsv_v, maxval=cfg.hsv_v)
            contrast = 1.0 + jax.random.uniform(kc, (n,), minval=-cfg.hsv_s / 2,
                                                maxval=cfg.hsv_s / 2)
            gains = jnp.stack([bright, contrast, jnp.zeros_like(bright)], -1)
        color = TA.ColorDraw(_t(gains), _t(jax.random.uniform(kp, (n,)) < cfg.color_p))
    return TA.AugmentDraws(mosaic, mix, hflip, vflip, color)


def assert_batches(got, ref, img_atol=0.0):
    for k in ("gt_bboxes", "gt_labels", "gt_mask", "sample_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["img"].numpy(), np.asarray(ref["img"]), rtol=0,
                               atol=img_atol)


RECIPES = {
    "mosaic": (JA.AugmentConfig(hflip_p=0.0, color_p=0.0, mosaic_p=1.0), 0.0),
    "mosaic_half": (JA.AugmentConfig(hflip_p=0.0, color_p=0.0, mosaic_p=0.5,
                                     min_box_size=0.05), 0.0),
    "mixup": (JA.AugmentConfig(hflip_p=0.0, color_p=0.0, mixup_p=1.0), 1e-6),
    "flips": (JA.AugmentConfig(hflip_p=0.5, vflip_p=0.5, color_p=0.0), 0.0),
    "hsv": (JA.AugmentConfig(hflip_p=0.0, color_p=0.7), 1e-6),
    "yolox": (JA.AugmentConfig(mosaic_p=1.0, mixup_p=1.0), 1e-6),
}


@pytest.mark.parametrize("C", [3, 1])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_batch_replays_jax_draws(recipe, C, seed):
    """The pipeline on the JAX draws equals ``JA.augment_batch``."""
    cfg, atol = RECIPES[recipe]
    batch = make_batch(seed, C)
    key = jax.random.PRNGKey(100 + seed)
    ref = JA.augment_batch({k: jnp.asarray(v) for k, v in batch.items()}, key, cfg)
    draws = jax_draws(key, B, C, cfg)
    got = TA.apply_augment(to_torch(batch), draws, TA.AugmentConfig(*cfg))
    assert_batches(got, ref, atol)
    if draws.mosaic is not None and bool(draws.mosaic.apply.all()):
        assert not np.array_equal(got["img"].numpy(), batch["img"])


def test_mosaic_offsets_at_the_canvas_edges(monkeypatch):
    """Offsets 0 and just below 1 (the crop start truncates to S - 1):
    exact against ``JA.mosaic4`` with its draws set to the same values."""
    batch = make_batch(3, 1)
    offsets = np.array([[0.0, 0.0], [0.99999994, 0.99999994], [0.5, 0.25], [0.03, 0.97]],
                       np.float32)
    partners = np.array([[1, 2, 3], [0, 0, 0], [3, 3, 1], [2, 1, 0]], np.int32)
    draw = TA.MosaicDraw(_t(partners, torch.int64), _t(offsets), torch.ones(B, dtype=bool))
    got = TA.mosaic_apply(to_torch(batch), draw, 2e-3)

    # mosaic4 draws partners, then offsets (B, 2), then its apply uniforms (B,)
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(partners))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: (
        jnp.asarray(offsets) if tuple(shape) == (B, 2) else jnp.zeros(shape)))
    ref = JA.mosaic4({k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), 1.0)
    assert_batches(got, ref)


def test_hsv_is_floor_mod_on_negative_hue():
    """Pixels with g < b (negative (g - b) / diff) and negative hue gains:
    ``%`` is floor-mod in JAX, so the hue wraps to [0, 1); torch.fmod would
    leave it negative."""
    img = np.array([[[[0.9, 0.1, 0.5], [0.8, 0.2, 0.7], [0.3, 0.3, 0.3], [0.2, 0.9, 0.1]]]],
                   np.float32)
    gains = np.array([[-0.015, 1.3, 0.8]], np.float32)
    ref = JA._hsv_to_rgb(jnp.stack([
        (JA._rgb_to_hsv(jnp.asarray(img))[..., 0] + gains[0, 0]) % 1.0,
        jnp.clip(JA._rgb_to_hsv(jnp.asarray(img))[..., 1] * gains[0, 1], 0, 1),
        jnp.clip(JA._rgb_to_hsv(jnp.asarray(img))[..., 2] * gains[0, 2], 0, 1)], -1))
    got = TA.hsv_apply(torch.from_numpy(img), TA.ColorDraw(_t(gains), torch.ones(1, dtype=bool)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    hsv = TA._rgb_to_hsv(torch.from_numpy(img))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(JA._rgb_to_hsv(jnp.asarray(img))),
                               rtol=0, atol=1e-6)
    assert float(hsv[..., 0].min()) >= 0.0


@pytest.mark.parametrize("shape,out", [((2, 40, 60, 3), 32), ((2, 10, 14, 1), 32),
                                       ((1, 48, 24, 3), 40)])
def test_letterbox_batch_matches_jax(shape, out):
    """Shrinking (antialiased) and growing."""
    imgs = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    ref, r_ref, pad_ref = JA.letterbox_batch(jnp.asarray(imgs), out)
    got, r, pad = TA.letterbox_batch(torch.from_numpy(imgs), out)
    assert (r, pad) == (r_ref, pad_ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("alpha", [8.0, 2.5, 0.7])
def test_beta_draw_moments(alpha):
    """Beta(alpha, alpha) from the explicit generator: the order statistic
    for integer alpha, Marsaglia-Tsang gammas otherwise."""
    n = 200_000
    x = TA.beta_draw(torch.Generator().manual_seed(0), alpha, n).double()
    var = 1.0 / (4.0 * (2.0 * alpha + 1.0))  # 1/68 at alpha 8
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert abs(float(x.mean()) - 0.5) < 4 * (var / n) ** 0.5
    # the sample variance's standard error: sqrt((m4 - var^2) / n)
    m4 = float(((x - 0.5) ** 4).mean())
    assert abs(float(x.var()) - var) < 4 * ((m4 - var ** 2) / n) ** 0.5


def test_draws_are_deterministic_per_seed_epoch_and_batch():
    cfg = TA.AugmentConfig(mosaic_p=1.0, mixup_p=1.0, vflip_p=0.5)

    def draws(*key):
        return TA.draw_augment(TA.batch_generator(*key), 8, 3, cfg)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(tuple(a)),
                                                     jax.tree_util.tree_leaves(tuple(b))))

    assert same(draws(43, 2, 5), draws(43, 2, 5))
    for other in [(43, 2, 6), (43, 3, 5), (44, 2, 5)]:
        assert not same(draws(43, 2, 5), draws(*other))
    for i in range(20):  # a mixup partner is never the image itself
        d = TA.draw_mixup(TA.batch_generator(0, 0, i), 4, 1.0)
        assert not bool((d.partner == torch.arange(4)).any())


def test_p_zero_is_the_identity():
    """Each op with probability 0 returns the batch unchanged, and so does
    the pipeline with every probability 0."""
    batch = to_torch(make_batch(5, 3))
    gen = torch.Generator().manual_seed(0)
    off = TA.AugmentConfig(hflip_p=0.0, vflip_p=0.0, mosaic_p=0.0, mixup_p=0.0, color_p=0.0)
    for out in (TA.mosaic4(batch, gen, 0.0), TA.mixup(batch, gen, 0.0),
                TA.random_hflip(batch, gen, 0.0), TA.random_vflip(batch, gen, 0.0),
                {**batch, "img": TA.hsv_jitter(batch["img"], gen, off)},
                TA.augment_batch(batch, gen, off)):
        for k, v in batch.items():
            assert torch.equal(out[k], v), k
    gray = batch["img"][..., :1]
    assert torch.equal(TA.gray_jitter(gray, gen, off), gray)


def test_augmented_boxes_stay_in_the_unit_square_and_above_min_box():
    batch = to_torch(make_batch(6, 1))
    cfg = TA.AugmentConfig(mosaic_p=1.0, mixup_p=1.0, vflip_p=0.5)
    out = TA.augment_batch(batch, TA.batch_generator(1, 0, 0), cfg)
    bb, m = out["gt_bboxes"], out["gt_mask"]
    assert bool(m.any())
    v = bb[m]
    assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0
    assert bool(((v[:, 2] - v[:, 0]) > cfg.min_box_size).all())
    assert bool(((v[:, 3] - v[:, 1]) > cfg.min_box_size).all())
