"""Port NMS (yolo_scratch_tpu_torch.ops.nms_kernels / ops.nms) vs the JAX
package: the Pallas kernels in interpret mode and the XLA pairwise sweep.

Every comparison here is exact (keep sets are booleans; the plain sweep
repeats the kernels' f32 operation order). The CUDA kernels themselves are
held against their plain versions in ``test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax

from yolo_scratch_tpu.ops.nms import gather_topk_detections_batched as jax_gather_topk
from yolo_scratch_tpu.ops.nms import nms as jax_nms
from yolo_scratch_tpu.ops import pallas_nms as jpallas
from yolo_scratch_tpu_torch.ops import nms as tnms
from yolo_scratch_tpu_torch.ops import nms_kernels as tk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(rng, shape, spread=64.0, size=25.0, min_size=3.0):
    c = rng.rand(*shape, 2).astype(np.float32) * spread
    wh = rng.rand(*shape, 2).astype(np.float32) * size + min_size
    return np.concatenate([c - wh / 2, c + wh / 2], -1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# (seed, B, N, spread, iou): the cases of tests/test_pallas_nms.py plus a
# dense B=4, N=512 case (the Predictor's K) with heavy overlap
SWEEP_CASES = [
    (0, 3, 64, 64.0, 0.5),
    (11, 2, 96, 150.0, 0.5),
    (3, 2, 80, 48.0, 0.45),
    (5, 4, 512, 96.0, 0.45),
]


@pytest.mark.parametrize("seed,B,N,spread,iou", SWEEP_CASES)
def test_sweep_batched_plain_matches_pallas(seed, B, N, spread, iou):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (B, N), spread)
    valid = rng.rand(B, N) > 0.15
    ref = np.asarray(jpallas.nms_sweep_pallas_batched(boxes, valid, iou, interpret=True))
    got = tk.nms_sweep_batched(_t(boxes), _t(valid), iou).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()  # the sweep suppressed something


def _two_phase_inputs(case):
    """(boxes (B, N, 4), valid (B, N), iou) for one case of the two-phase test."""
    rng = np.random.RandomState(17)
    if case.startswith("n="):  # ragged and whole 64-pivot blocks
        n = int(case[2:])
        return _boxes(rng, (2, n), 96.0), rng.rand(2, n) > 0.15, 0.45
    if case == "dense":  # heavy suppression: many kept pivots' words OR'd
        return _boxes(rng, (2, 150), 24.0), rng.rand(2, 150) > 0.1, 0.45
    if case == "invalid_rows":  # one image with no valid box
        valid = rng.rand(3, 90) > 0.15
        valid[1] = False
        return _boxes(rng, (3, 90), 64.0), valid, 0.5
    if case.startswith("ties"):  # the boxes of test_kernel_threshold_ties_match_plain
        boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [0, 0, 10, 4.5], [0, 0, 10, 5.0],
                          [0, 0, 10, 7.0], [100, 100, 110, 110], [100.5, 100, 110.5, 110]],
                         np.float32)[None]
        return boxes, np.ones(boxes.shape[:2], bool), float(case.split("@")[1])
    if case == "negative_thr":  # every IoU, 0 included, exceeds it: the divide is not skipped
        return _boxes(rng, (2, 70), 150.0), rng.rand(2, 70) > 0.15, -0.1
    raise ValueError(case)


@pytest.mark.parametrize("case", ["n=1", "n=63", "n=64", "n=65", "n=200", "dense",
                                  "invalid_rows", "ties@0.45", "ties@0.5", "ties@0.7",
                                  "negative_thr"])
def test_two_phase_plain_matches_sweep_and_pallas(case):
    """The CUDA kernels' two phases, in plain PyTorch: mask words (with and
    without the valid flags) then the serial reduce equal the plain sweep
    and the Pallas kernel (interpret mode) exactly; the words hold no bit at
    j <= i or j >= N."""
    boxes, valid, iou = _two_phase_inputs(case)
    words = tk.nms_iou_mask_plain(_t(boxes), iou)
    B, n = valid.shape
    assert words.dtype == torch.int64 and tuple(words.shape) == (B, n, -(-n // 64))
    got = tk.nms_reduce_plain(words, _t(valid)).numpy()
    np.testing.assert_array_equal(got, tk.nms_sweep_batched_plain(_t(boxes), _t(valid),
                                                                  iou).numpy())
    # the kernel's mask leaves out invalid rows and columns: the same keep
    np.testing.assert_array_equal(
        tk.nms_reduce_plain(tk.nms_iou_mask_plain(_t(boxes), iou, _t(valid)), _t(valid)).numpy(),
        got)
    ref = np.asarray(jpallas.nms_sweep_pallas_batched(boxes, valid, iou, interpret=True))
    np.testing.assert_array_equal(got, ref)
    # unpack by shifts (bit 63 is the sign bit): only i < j < n may be set
    bits = ((words[..., None] >> torch.arange(64)) & 1).reshape(B, n, -1)
    assert not bits[..., n:].any()
    assert not bits[..., :n][:, torch.arange(n)[None, :] <= torch.arange(n)[:, None]].any()
    if case == "dense":
        assert 0 < got.sum() < valid.sum() / 2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [40, 200])
def test_sweep_single_plain_matches_pallas(seed, n):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, (n,))
    valid = rng.rand(n) > 0.2
    ref = np.asarray(jpallas.nms_sweep_pallas(boxes, valid, 0.5, interpret=True))
    got = tk.nms_sweep(_t(boxes), _t(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("presorted", [False, True])
def test_nms_kernel_batched_matches_pallas(class_aware, presorted):
    rng = np.random.RandomState(3)
    B, n = 2, 80
    boxes = _boxes(rng, (B, n), 48.0, 30.0, 5.0)
    scores = rng.rand(B, n).astype(np.float32)
    if presorted:
        scores = -np.sort(-scores, axis=1)
    valid = scores > 0.1
    labels = rng.randint(0, 4, (B, n)).astype(np.int32)
    kw = dict(iou_threshold=0.5, max_det=30, class_aware=class_aware, presorted=presorted)
    ref = np.asarray(jpallas.nms_pallas_batched(
        boxes, scores, valid, interpret=True, class_ids=labels, **kw))
    got = tk.nms_kernel_batched(_t(boxes), _t(scores), _t(valid), class_ids=_t(labels),
                                **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum(1).max() == 30  # max_det bound


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("class_aware", [False, True])
def test_nms_kernel_matches_pallas(seed, class_aware):
    rng = np.random.RandomState(seed)
    n = 120
    boxes = _boxes(rng, (n,), 48.0, 30.0, 5.0)
    scores = rng.rand(n).astype(np.float32)
    valid = scores > 0.1
    labels = rng.randint(0, 4, n).astype(np.int32)
    kw = dict(iou_threshold=0.5, max_det=25, class_aware=class_aware)
    ref = np.asarray(jpallas.nms_pallas(boxes, scores, valid=valid, interpret=True,
                                        class_ids=labels, **kw))
    got = tk.nms_kernel(_t(boxes), _t(scores), valid=_t(valid), class_ids=_t(labels),
                        **kw).numpy()
    np.testing.assert_array_equal(got, ref)


def test_nms_kernel_max_det():
    n = 30
    boxes = np.zeros((n, 4), np.float32)
    boxes[:, 0] = np.arange(n) * 100.0
    boxes[:, 2] = boxes[:, 0] + 10
    boxes[:, 3] = 10
    scores = np.linspace(1, 0.1, n).astype(np.float32)
    keep = tk.nms_kernel(_t(boxes), _t(scores), max_det=7).numpy()
    assert keep.sum() == 7 and keep[:7].all()


def test_class_offset_span_is_over_whole_batch():
    """span = max|boxes| over ALL images (pallas_nms.py), not per image."""
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, (3, 16))
    boxes[2] *= 10.0  # one image with much larger coordinates
    labels = rng.randint(0, 5, (3, 16)).astype(np.int32)
    ref = np.asarray(jpallas._class_offset(jax.numpy.asarray(boxes), jax.numpy.asarray(labels)))
    got = tk._class_offset(_t(boxes), _t(labels)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("presorted", [False, True])
def test_pairwise_nms_matches_jax(seed, class_aware, presorted):
    rng = np.random.RandomState(seed)
    n = 150
    boxes = _boxes(rng, (n,), 64.0)
    scores = rng.rand(n).astype(np.float32)
    if presorted:
        scores = -np.sort(-scores)
    valid = scores > 0.2
    labels = rng.randint(0, 3, n).astype(np.int32)
    kw = dict(iou_threshold=0.45, max_det=40, class_aware=class_aware, presorted=presorted)
    ref = np.asarray(jax_nms(boxes, scores, valid=valid, class_ids=labels, **kw))
    got = tnms.nms(_t(boxes), _t(scores), valid=_t(valid), class_ids=_t(labels), **kw).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("max_det", [5, 40])  # 40 > N pads the outputs
def test_gather_topk_detections_matches_jax_with_ties(max_det):
    """Many equal scores: the port must order them lower index first, as
    XLA's top_k does."""
    rng = np.random.RandomState(2)
    B, n = 2, 24
    boxes = _boxes(rng, (B, n))
    scores = rng.choice(np.array([0.3, 0.5, 0.9], np.float32), (B, n))
    labels = rng.randint(0, 7, (B, n)).astype(np.int32)
    keep = rng.rand(B, n) > 0.3
    ref = jax_gather_topk(boxes, scores, labels, keep, max_det)
    got = tnms.gather_topk_detections_batched(_t(boxes), _t(scores), _t(labels), _t(keep),
                                              max_det)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the single-image form is the batched one's row 0
    one = tnms.gather_topk_detections(_t(boxes[0]), _t(scores[0]), _t(labels[0]), _t(keep[0]),
                                      max_det)
    for r, g in zip(ref, one):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[0])


def test_sweep_rejects_unsupported_device():
    boxes = torch.zeros((1, 8, 4), device="meta")
    valid = torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.nms_sweep_batched(boxes, valid)


@pytest.mark.parametrize("iou", [0.45, 0.5, 0.7])
def test_sweep_batched_plain_matches_jax_xla_at_eval_cap(iou):
    """The eval step's NMS: the port runs kernel #1 (its plain version on
    the CPU) where the JAX eval step runs the XLA sweep (``ops/nms.py::nms``,
    presorted, vmapped). Keep sets must be equal at the step's cap, N=2048.
    Besides dense random boxes, each image holds 100 planted triples: a
    20x20 box, the same box cut to height 20*iou (IoU 400*iou/400, exactly
    the threshold in f32: the union's 1e-6 vanishes at 400) and one cut half
    a pixel taller (just above it)."""
    rng = np.random.RandomState(int(iou * 100))
    B, n, t = 2, 2048, 100
    boxes = _boxes(rng, (B, n), 160.0, 40.0, 5.0)
    xy = rng.randint(0, 160, (B, t, 1, 2)).astype(np.float32)
    h = np.array([20.0, 20.0 * iou, 20.0 * iou + 0.5], np.float32)
    planted = np.concatenate([np.broadcast_to(xy, (B, t, 3, 2)),
                              xy + np.stack([np.full(3, 20.0, np.float32), h], -1)], -1)
    boxes[:, : 3 * t] = planted.reshape(B, 3 * t, 4)
    valid = rng.rand(B, n) > 0.1
    valid[:, : 3 * t] = True
    sweep = jax.jit(jax.vmap(lambda b, v: jax_nms(b, jax.numpy.zeros(n), iou, max_det=n,
                                                  valid=v, presorted=True)))
    ref = np.asarray(sweep(boxes, valid))
    got = tk.nms_sweep_batched(_t(boxes), _t(valid), iou).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < valid.sum()
    # the planted ties are ties: IoU == threshold in f32, and the box at the
    # threshold survives its 20x20 pivot where the taller one does not
    a, b = _t(planted[0, :, 0]), _t(planted[0, :, 1])
    inter = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    area = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    assert bool((inter / (area + inter - inter + 1e-6) == float(np.float32(iou))).all())
    kept = got[:, : 3 * t].reshape(B, t, 3)
    assert (kept[..., 0] & kept[..., 1]).any() and not (kept[..., 0] & kept[..., 2]).any()
