"""Port evaluation path (yolo_scratch_tpu_torch: data, utils.metrics,
ops.matching, train.steps, val) vs the JAX package on the same inputs.

Stated tolerances:

* ``SyntheticDataset`` items, ``Loader`` batches (serial, prefetched,
  ``workers=2``, wrap-padded, shuffled, multiscale) and every
  ``utils.metrics`` output: exact (numpy copies of the same code), on the
  inputs of ``test_metrics_parity.py``, ``test_coco_summary.py`` and
  ``test_val_padding.py``.
* ``batched_tp_marks`` (plain and per-class) and ``batched_tp_marks_area``:
  bit-exact, including IoUs that land exactly on a threshold and equal
  IoUs (ties go to the lowest GT index).
* ``make_eval_step`` on the same raw maps as the JAX step: valid, labels,
  marks (plain and per-class) and ``prefilter_saturated`` exact; scores
  within 2 ulp and boxes within ``atol = 2e-6`` (``test_torch_decode.py``'s
  tolerances: ``exp`` and the DFL sum round differently in the two
  frameworks); the loss triplet ``rtol = 1e-4``. The port runs NMS as
  ``"kernel"`` (its plain version on the CPU), the JAX step as ``"xla"``.
* ``val.main`` against the JAX ``val.main`` with ``--torch-ckpt`` on one
  saved checkpoint, at ``--imgsz 64 --batch 4 --max-batches 1``: the same
  JSON keys; every metric within ``1e-6``; the loss, which goes from
  images through the weight bridge, ``rtol = 1e-4``.
"""

import threading
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

from tests.test_coco_summary import _random_scene
from tests.test_device_matching import _random_case
from tests.test_metrics_parity import _random_eval_data
from tests.test_torch_infer import _seeded_model
from yolo_scratch_tpu import val as jval
from yolo_scratch_tpu.data.loader import Loader as JLoader
from yolo_scratch_tpu.data.synthetic import SyntheticDataset as JSynthetic
from yolo_scratch_tpu.losses.v8_loss import DetectionLossConfig as JLossConfig
from yolo_scratch_tpu.ops import matching as jmatch
from yolo_scratch_tpu.train.steps import make_eval_step as jax_make_eval_step
from yolo_scratch_tpu.utils import metrics as jmet
from yolo_scratch_tpu_torch import val as tval
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.ops import matching as tmatch
from yolo_scratch_tpu_torch.train import steps as tsteps
from yolo_scratch_tpu_torch.utils import metrics as tmet

NC, REG, STRIDES = 5, 16, (8.0, 16.0, 32.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("channels,seed", [(1, 0), (3, 5)])
def test_synthetic_items_equal_jax(channels, seed):
    kw = dict(n=6, img_size=64, channels=channels, num_classes=5, seed=seed)
    got, ref = SyntheticDataset(**kw), JSynthetic(**kw)
    assert len(got) == len(ref) == 6
    for i in range(6):
        for g, r in zip(got[i], ref[i]):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


LOADER_CASES = {
    # test_val_padding.py's loader: 6 of 8 images in batches of 4, wrap-padded
    "wrap_padding": dict(batch_size=4, max_gt=8, prefetch=0, indices=[0, 1, 2, 3, 4, 5]),
    "prefetch": dict(batch_size=3, max_gt=2, prefetch=2),
    "workers": dict(batch_size=3, max_gt=8, prefetch=2, workers=2),
    "shuffle": dict(batch_size=4, max_gt=8, prefetch=0, shuffle=True, seed=3),
    "multiscale": dict(batch_size=2, max_gt=8, prefetch=0, multiscale_sizes=[48, 64],
                       multiscale_interval=1),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_equal_jax(case):
    ds_kw = dict(n=8, img_size=64, channels=1, num_classes=5)
    got_loader = Loader(SyntheticDataset(**ds_kw), **LOADER_CASES[case])
    ref_loader = JLoader(JSynthetic(**ds_kw), **LOADER_CASES[case])
    for _ in range(2):  # two epochs: the shuffle and bucket draws move with the epoch
        got, ref = list(got_loader), list(ref_loader)
        _assert_batches_equal(got, ref)
    got_loader.close()
    if case == "wrap_padding":
        assert got[1]["sample_valid"].tolist() == [True, True, False, False]


def test_loader_close_ends_pool_and_early_break_ends_prefetch_thread():
    ds = SyntheticDataset(n=12, img_size=64)
    loader = Loader(ds, batch_size=2, max_gt=8, prefetch=1, workers=2)
    before = set(threading.enumerate())
    first = None
    for batch in loader:  # stop after one batch: the prefetch thread must end
        first = batch
        break
    assert loader._pool is not None
    loader.close()
    assert loader._pool is None
    # neither the prefetch thread nor a pool worker outlives close()
    assert set(threading.enumerate()) <= before
    # the loader still works and gives the same batches (a new pool)
    again = list(loader)
    loader.close()
    assert len(again) == 6
    _assert_batches_equal(again[:1], [first])


# --------------------------------------------------------------- metrics

@pytest.mark.parametrize("seed", [0, 1, 5])
def test_host_metrics_equal_jax(seed):
    """test_metrics_parity.py's inputs through every host scorer."""
    preds, targets = _random_eval_data(seed)
    for fn, kw in [("evaluate_detections", dict(conf_threshold=0.25)),
                   ("evaluate_per_class", dict(num_classes=5, conf_threshold=0.25)),
                   ("evaluate_cda_full", {}), ("evaluate_cda_proxy", {})]:
        assert getattr(tmet, fn)(preds, targets, **kw) == getattr(jmet, fn)(preds, targets,
                                                                            **kw), fn
    p = preds[0]
    got = tmet.cda_nms(dict(p), max_detections=5)
    ref = jmet.cda_nms(dict(p), max_detections=5)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def _scenes(seed, B=4, n=24, g=10):
    """test_coco_summary.py's scenes, stacked: (pb, scores, pv, gb, gm)."""
    rng = np.random.RandomState(seed)
    scenes = [_random_scene(rng, n=n, g=g) for _ in range(B)]
    return tuple(np.stack([s[i] for s in scenes]) for i in range(5)), rng


def test_marks_metrics_equal_jax():
    (pb, scores, pv, gb, gm), rng = _scenes(42, B=6)
    pl = rng.randint(0, 4, pv.shape).astype(np.int32)
    gl = rng.randint(0, 4, gm.shape).astype(np.int32)
    pl[:, :5] = gl[:, :5]
    tp = np.asarray(jmatch.batched_tp_marks(pb, pv, gb, gm))
    tp_cls = np.asarray(jmatch.batched_tp_marks(pb, pv, gb, gm, pred_labels=pl, gt_labels=gl))
    n_gt = int(gm.sum())
    bands = {name: tuple(np.asarray(x) if not isinstance(x, int) else x
                         for x in jmatch.batched_tp_marks_area(pb, pv, gb, gm, lo, hi))
             for name, (lo, hi) in jmet.COCO_AREA_BANDS.items()}
    calls = [("metrics_from_marks", (tp, scores, pv, n_gt)),
             ("coco_summary_from_marks", (tp, scores, pv, n_gt, bands)),
             ("coco_strict_ap_from_marks", (tp_cls, scores, pl, pv, gl, gm, 4)),
             ("per_class_from_marks", (tp_cls, scores, pl, pv, gl, gm, 4))]
    for fn, args in calls:
        got, ref = getattr(tmet, fn)(*args), getattr(jmet, fn)(*args)
        assert got == ref, fn
    assert ref and tmet.metrics_from_marks(tp, scores, pv, n_gt)["mAP50"] > 0


# -------------------------------------------------------------- matching

def _tie_case():
    """Integer boxes whose IoUs land exactly on thresholds (the union's
    1e-6 vanishes in f32 at 100: IoU 50/100 == f32(0.5) exactly), equal IoUs
    (duplicate GTs and duplicate detections), a padded GT, and a tie that
    decides a later match: the second-to-last detection has IoU 0.6 with GTs
    5 and 6; it must take GT 5 (the lower index), which leaves the last
    detection, GT 5's own box, only GT 6 (IoU 1/3)."""
    gt = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50],
                   [0, 0, 0, 0], [100, 100, 110, 110], [100, 105, 110, 115]], np.float32)
    det = np.array([[0, 0, 10, 5], [0, 0, 10, 5.5], [20, 20, 30, 27], [20, 20, 30, 27],
                    [40, 40, 50, 45], [40, 40, 50, 49.5], [0, 0, 10, 7.5], [60, 60, 70, 70],
                    [100, 102.5, 110, 112.5], [100, 100, 110, 110]], np.float32)
    pv = np.ones((1, len(det)), bool)
    pv[0, 6] = False
    gm = np.array([[True, True, True, True, False, True, True]])
    pl = np.array([[0, 1, 2, 2, 3, 3, 0, 1, 4, 4]], np.int32)
    gl = np.array([[0, 1, 2, 3, 0, 4, 4]], np.int32)
    return det[None], pv, gt[None], gm, pl, gl


def _matching_cases():
    for seed in (0, 1, 2):
        pb, _, pv, gb, gm = _random_case(seed)
        rng = np.random.RandomState(seed)
        yield (pb, pv, gb, gm, rng.randint(0, 3, pv.shape).astype(np.int32),
               rng.randint(0, 3, gm.shape).astype(np.int32))
    yield _tie_case()


@pytest.mark.parametrize("case", range(4))
def test_tp_marks_bit_exact(case):
    pb, pv, gb, gm, pl, gl = list(_matching_cases())[case]
    for labels in (False, True):
        kw = dict(pred_labels=pl, gt_labels=gl) if labels else {}
        ref = np.asarray(jmatch.batched_tp_marks(pb, pv, gb, gm, **kw))
        got = tmatch.batched_tp_marks(_t(pb), _t(pv), _t(gb), _t(gm),
                                      **{k: _t(v) for k, v in kw.items()})
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref)
        assert ref.any()
    if case == 3:  # the threshold hits: det 0 is TP at IoU 0.5 only, det 2 at 0.7 only
        assert ref[0, :, 0].tolist() == [True] + [False] * 9
        assert ref[0, :, 2].tolist() == [True] * 5 + [False] * 5
        # the tie went to GT 5: where det 8 (IoU 0.6) is a TP, det 9 is not
        assert ref[0, :3, 8].all() and not ref[0, :3, 9].any() and ref[0, 3:, 9].all()


@pytest.mark.parametrize("band", ["small", "medium", "large", "all", "tie"])
def test_area_marks_bit_exact(band):
    if band == "tie":
        pb, pv, gb, gm, _, _ = _tie_case()
        lo, hi = 0.0, 60.0  # the 50 px^2 detections are in band, 100 px^2 GTs are not
    else:
        (pb, _, pv, gb, gm), _ = _scenes(7 + len(band))
        lo, hi = jmet.COCO_AREA_BANDS.get(band, (0.0, 1e10))
    ref = jmatch.batched_tp_marks_area(pb, pv, gb, gm, lo, hi)
    got = tmatch.batched_tp_marks_area(_t(pb), _t(pv), _t(gb), _t(gm), lo, hi)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[2] == ref[2]
    assert np.asarray(ref[0]).any() or np.asarray(ref[1]).any()


# ------------------------------------------------------------- eval step

class _State(NamedTuple):
    params: Any
    batch_stats: Any
    ema_params: Any = None


class _MapsModel:
    """JAX-side model whose forward returns the maps held in its params, so
    both steps see the same raw maps."""
    nc, strides, reg_max = NC, STRIDES, REG

    @staticmethod
    def apply(variables, img, train=False):
        return variables["params"]["feats"]


def _maps(seed, B, img=64):
    rng = np.random.RandomState(seed)
    return [np.concatenate([rng.normal(0, 2, (B, int(img // s), int(img // s), 4 * REG)),
                            rng.normal(-1, 2, (B, int(img // s), int(img // s), NC))],
                           -1).astype(np.float32) for s in STRIDES]


STEP_KW = dict(conf_threshold=0.25, iou_threshold=0.45, max_det=30, pre_nms_topk=40,
               match_thresholds=jmatch.DEFAULT_THRESHOLDS, per_class=True)


def test_eval_step_on_the_same_maps_matches_jax():
    feats = _maps(0, 4)
    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=64), 4, max_gt=8, prefetch=0)))
    batch["sample_valid"] = np.array([True, True, True, False])
    step = tsteps.make_eval_step(build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=NC),
                                 **STEP_KW)
    # GT at some of the port's detections, jittered, so that marks hit
    # every threshold band
    first = step.from_feats([_t(f) for f in feats], tsteps.batch_to_device(batch, "cpu"))
    boxes, valid = first[1][0].numpy(), first[1][3].numpy()
    rng = np.random.RandomState(1)
    for b in range(4):
        k = min(int(valid[b].sum()), 6)
        batch["gt_bboxes"][b, :k] = boxes[b, :k] + rng.normal(0, 0.01, (k, 4))
        batch["gt_mask"][b, :k] = True

    got = step.from_feats([_t(f) for f in feats], tsteps.batch_to_device(batch, "cpu"))
    jstep = jax_make_eval_step(_MapsModel(), JLossConfig(nc=NC, strides=STRIDES), **STEP_KW)
    ref = jstep(_State({"feats": feats}, {}), batch)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(got[0][k]), float(ref[0][k]), rtol=1e-4, err_msg=k)
    assert float(got[0]["prefilter_saturated"]) == float(ref[0]["prefilter_saturated"]) > 0
    (gb, gs, gl, gv), (rb, rs, rl, rv) = got[1], ref[1]
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    np.testing.assert_array_max_ulp(gs.numpy(), np.asarray(rs), maxulp=2)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0, atol=2e-6)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    marks = np.asarray(ref[2])
    assert marks[:, 0].any() and marks[:, -1].sum() < marks[:, 0].sum()


def test_eval_step_options_not_ported_raise():
    """Every eval-step option is ported now: ``loss_fn`` and ``decode_fn``
    (the YOLOX path) replace the v8 loss and the fused decode. An unknown
    matmul precision still raises."""
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=NC)
    decode = lambda f: model.decode(f)  # noqa: E731
    step = tsteps.make_eval_step(model, loss_fn=lambda f, b: (torch.zeros(()), {}),
                                 decode_fn=decode)
    assert step.decode_fn is decode and step.loss_fn(None, None)[1] == {}
    with pytest.raises(ValueError, match="matmul_precision"):
        with tsteps.precision_scope("fastest"):
            pass


def test_precision_scope_turns_tf32_off_and_restores():
    """JAX "highest" and "high" (bf16x3 passes; torch's "high" would be
    TF32) both turn TF32 off for cuBLAS and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for name in ("highest", "high"):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            with tsteps.precision_scope(name):
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -------------------------------------------------------------------- val

def eval_model():
    """test_torch_infer.py's seeded crater YOLO11n (random BN statistics,
    zeroed class-bias priors), with the box branch's last conv scaled down
    and its bias peaked at bin 1: every anchor predicts a box about two
    strides wide, so some land on the synthetic GTs and the metrics are not
    all zero."""
    model = _seeded_model()
    with torch.no_grad():
        for box in model.model[-1].cv2:
            box[2].weight.mul_(0.05)
            box[2].bias.copy_(-4.0 * (torch.arange(float(REG)) - 1.0).abs().repeat(4))
    return model


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("val") / "best.pt"
    torch.save({"model_state_dict": eval_model().state_dict(), "epoch": 3}, path)
    return str(path)


VAL_ARGS = ["--data", "synthetic", "--imgsz", "64", "--batch", "4", "--max-batches", "1",
            "--per-class", "--coco-summary", "--cda"]


def test_val_main_matches_jax(ckpt):
    got = tval.main(VAL_ARGS + ["--torch-ckpt", ckpt, "--device", "cpu"])
    ref = jval.main(VAL_ARGS + ["--torch-ckpt", ckpt])
    assert list(got) == list(ref)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    for k in ref:
        if k != "loss":
            assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    assert ref["mAP50"] > 0 and ref["coco/AP75"] > 0  # the matches are not all misses


def test_val_host_match_equals_device_marks(ckpt):
    args = VAL_ARGS[:-3] + ["--torch-ckpt", ckpt, "--device", "cpu"]
    dev = tval.main(args)
    host = tval.main(args + ["--host-match"])
    for k in ("precision", "recall", "mAP50", "mAP50-95", "loss"):
        assert host[k] == pytest.approx(dev[k], abs=1e-6), k


def test_val_runs_on_cuda_by_default_and_never_falls_back(monkeypatch, ckpt):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tval.main(["--imgsz", "64", "--max-batches", "1"])
    with pytest.raises(FileNotFoundError, match="no COCO annotations"):  # not a dataset
        tval.main(["--data", "/nonexistent", "--device", "cpu", "--imgsz", "64"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):  # --ckpt: an empty dir
        tval.main(["--ckpt", str(Path(ckpt).parent), "--device", "cpu", "--imgsz", "64"])
