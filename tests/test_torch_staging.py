"""The deploy batch's way to the card without a host wait.

On the CPU: ``make_anchors`` builds the grid with torch ops on the target
device and equals the numpy construction it replaced bit for bit (f32 and
the casts to bf16 and f16), and a CPU Predictor takes the plain path: a
host batch gives the packed output that the numpy grid gives, and counts
no staged batch.

The cases marked ``gpu`` run the Predictor on the card, where a host batch
goes through ``infer.py::PinnedRing`` (pinned slots, a side stream):

* its packed output equals that of the same batch already on the card, bit
  for bit (YOLO11n-crater at ``pre_nms_topk`` 512 and 8400, YOLOX-s);
* a warmed batch makes no stream sync (``torch.cuda.set_sync_debug_mode``
  raises on one, as a blocking copy from pageable memory makes);
* the caller may overwrite its array as soon as ``predict_batch`` returns;
* 2 x (``inflight`` + 1) distinct batches with ``inflight`` in flight each
  give their own result, so no slot is reused early;
* under a profiler ``h2d.staged`` counts every host batch and no batch
  already on the card, and ``h2d.slot_waits`` stays 0;
* threads sharing one Predictor (more than the host's cores, two slots)
  each get their own batch's result.

This file imports no JAX, so the card's cases run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_staging.py -q
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolo_scratch_tpu_torch import infer
from yolo_scratch_tpu_torch.models import yolox as yolox_mod
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.ops import decode
from yolo_scratch_tpu_torch.ops.anchors import feat_shapes_for, make_anchors
from yolo_scratch_tpu_torch.utils import profiling

FAMILIES = {
    "yolo11-crater": (lambda: build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5,
                                           scale="n", seed=3), 1),
    "yolox-s": (lambda: build_yolox("s", nc=80, ch=3, seed=3), 3),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def numpy_anchors(hw_strides, grid_cell_offset=0.5, dtype=torch.float32, device="cpu"):
    """The grid as the port built it before: numpy, then one copy."""
    pts, strides = [], []
    for h, w, s in hw_strides:
        sx = np.arange(w, dtype=np.float32) + grid_cell_offset
        sy = np.arange(h, dtype=np.float32) + grid_cell_offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        pts.append(np.stack([gx, gy], axis=-1).reshape(-1, 2))
        strides.append(np.full((h * w, 1), s, dtype=np.float32))
    return (torch.as_tensor(np.concatenate(pts), dtype=dtype, device=device),
            torch.as_tensor(np.concatenate(strides), dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("offset", [0.5, 0.0])
@pytest.mark.parametrize("img_hw", [(640, 640), (480, 640), (640, 480)],
                         ids=["640", "640x480", "480x640"])
def test_make_anchors_equals_the_numpy_grid(img_hw, offset, dtype):
    """The 640 grid (80/40/20: the crater and COCO cells) and non-square
    ones, YOLO11's offset 0.5 and YOLOX's 0.0, in each working dtype."""
    shapes = feat_shapes_for(img_hw, (8.0, 16.0, 32.0))
    got = make_anchors(shapes, offset, dtype=dtype)
    ref = numpy_anchors(shapes, offset, dtype=dtype)
    assert got[0].shape == (sum(h * w for h, w, _ in shapes), 2)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.device.type == "cpu"
        assert torch.equal(g, r)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def cpu_predictor(request):
    build, ch = FAMILIES[request.param]
    cfg = infer.PredictorConfig(img_size=64, batch_size=2, conf_threshold=0.0, bf16=False,
                                pre_nms_topk=32, max_det=20)
    x = np.random.RandomState(ch).randint(0, 256, (2, 64, 64, ch), dtype=np.uint8)
    return infer.Predictor(build().eval(), cfg, device="cpu"), x


def test_cpu_predictor_takes_the_plain_path(cpu_predictor, monkeypatch):
    """A host batch on a CPU Predictor: no ring, no staged batch, and the
    packed output the numpy anchor grid gives, bit for bit."""
    pred, x = cpu_predictor
    assert pred._ring is None
    with profile(activities=[ProfilerActivity.CPU]):
        got = pred.predict_batch(x)
    assert "h2d.staged" not in profiling.counters()
    monkeypatch.setattr(decode, "make_anchors", numpy_anchors)
    monkeypatch.setattr(yolox_mod, "make_anchors", numpy_anchors)
    assert torch.equal(got, pred.predict_batch(x))
    assert torch.equal(got, pred.predict_batch(torch.from_numpy(x)))


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the pinned ring and kernel #1 run only on a card")
    return torch.device("cuda")


CARD_CASES = {"yolo11-crater-top512": ("yolo11-crater", 512),
              "yolo11-crater-top8400": ("yolo11-crater", 8400),
              "yolox-s-top512": ("yolox-s", 512)}
CARD_B, CARD_IMG = 4, 640


def _card_predictor(cuda, case, inflight=3):
    family, topk = CARD_CASES[case]
    build, ch = FAMILIES[family]
    cfg = infer.PredictorConfig(img_size=CARD_IMG, batch_size=CARD_B, conf_threshold=0.0,
                                pre_nms_topk=topk, inflight=inflight)
    return infer.Predictor(build(), cfg, device=cuda), ch


def _batches(ch, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (CARD_B, CARD_IMG, CARD_IMG, ch), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_host_batch_equals_the_batch_on_the_card(cuda, case):
    pred, ch = _card_predictor(cuda, case)
    x, = _batches(ch, 1)
    ref = pred.predict_batch(torch.from_numpy(x).to(cuda)).cpu()
    assert pred._ring.bufs == []  # a batch on the card takes no slot
    for host in (x, torch.from_numpy(x)):
        assert torch.equal(pred.predict_batch(host).cpu(), ref)
    assert int(ref[..., 6].sum()) > 0  # conf 0: every image has detections


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_warmed_host_batch_makes_no_stream_sync(cuda, family):
    pred, ch = _card_predictor(cuda, f"{family}-top512")
    x, = _batches(ch, 1)
    pred.predict_batch(x).cpu()  # builds kernel #1, allocates the ring
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pred.predict_batch(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (CARD_B, 300, 7)


@pytest.mark.gpu
def test_the_caller_may_overwrite_its_array_at_once(cuda):
    pred, ch = _card_predictor(cuda, "yolo11-crater-top512")
    a, b = _batches(ch, 2)
    ref = pred.predict_batch(torch.from_numpy(a).to(cuda)).cpu()
    x = a.copy()
    out = pred.predict_batch(x)
    x[:] = b  # while the copy may still be queued
    assert torch.equal(out.cpu(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("inflight", [1, 3])
def test_each_batch_in_flight_keeps_its_own_slot(cuda, inflight):
    """2 x (inflight + 1) distinct batches, ``inflight`` of them in flight,
    as ``predict_paths`` keeps them: each result is its own batch's, every
    host batch is counted as staged, and none waited for a slot."""
    pred, ch = _card_predictor(cuda, "yolo11-crater-top512", inflight=inflight)
    xs = _batches(ch, 2 * (inflight + 1), seed=inflight)
    refs = [pred.predict_batch(torch.from_numpy(x).to(cuda)).cpu() for x in xs]
    pred.predict_batch(xs[0]).cpu()  # warm the ring
    got, pending = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for x in xs:
            pending.append(pred.predict_batch(x))
            if len(pending) >= inflight:
                got.append(pending.pop(0).cpu())
        got += [p.cpu() for p in pending]
        pred.predict_batch(torch.from_numpy(xs[0]).to(cuda)).cpu()  # not staged
    assert all(torch.equal(g, r) for g, r in zip(got, refs)) and len(got) == len(refs)
    c = profiling.counters()
    assert c.get("h2d.staged") == len(xs) and c.get("h2d.slot_waits", 0) == 0


@pytest.mark.gpu
def test_threads_sharing_a_predictor_each_get_their_own_batch(cuda):
    pred, ch = _card_predictor(cuda, "yolo11-crater-top512", inflight=1)
    xs = _batches(ch, 6, seed=7)
    refs = [pred.predict_batch(torch.from_numpy(x).to(cuda)).cpu() for x in xs]
    pred.predict_batch(xs[0]).cpu()  # warm the ring
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(2 * (os.cpu_count() or 4)) as pool:
            futures = [pool.submit(lambda k: pred.predict_batch(xs[k % len(xs)]).cpu(), k)
                       for k in range(4 * len(xs))]
            got = [f.result(timeout=300) for f in futures]
    finally:
        sys.setswitchinterval(switch)
    assert all(torch.equal(g, refs[k % len(xs)]) for k, g in enumerate(got))
