"""The port's spans and counters (``utils/profiling.py``) on the CPU: with no
profiler they cost a flag test and leave nothing behind; under
``torch.profiler`` the Predictor and the train step record their layers'
spans in order, and the NMS counters count what the benchmark's roofline
counts.

Every case is exact: names, orders and integer counts. The cases marked
``gpu`` run the same on the card (kernels #1 and #2, cuDNN), where every
kernel a Predictor batch launches falls under exactly one span; this file
imports no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.roofline import nms_tests
from benchmark.trace import traced
from yolo_scratch_tpu_torch import infer
from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.ops import decode
from yolo_scratch_tpu_torch.ops.nms_kernels import nms_sweep_batched_plain
from yolo_scratch_tpu_torch.train.optim import make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state
from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, yolox_loss_adapter
from yolo_scratch_tpu_torch.utils import profiling

IMG, B, TOPK = 64, 2, 32
DEPLOY = ["yst.h2d", "yst.normalize", "yst.model", "yst.select", "yst.nms", "yst.pack"]
PHASES = ["h2d", "forward", "loss", "backward", "clip_adamw_ema"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the NMS kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


FAMILIES = {
    "yolo11-crater": (lambda: build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5,
                                           scale="n", seed=3), 1),
    "yolox-s": (lambda: build_yolox("s", nc=80, ch=3, seed=3), 3),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def predictor(request):
    build, ch = FAMILIES[request.param]
    cfg = infer.PredictorConfig(img_size=IMG, batch_size=B, conf_threshold=0.0, bf16=False,
                                pre_nms_topk=TOPK, max_det=20)
    x = np.random.RandomState(ch).randint(0, 256, (B, IMG, IMG, ch), dtype=np.uint8)
    return infer.Predictor(build().eval(), cfg, device="cpu"), x


def _spans(prof, prefix="yst."):
    """[(name, start, end)] of the trace's ``prefix`` spans, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda s: s[1])


def _sequence(spans, names):
    """The names of ``spans`` in order, runs of one name merged (a layer
    may record more than one interval in a row)."""
    out = []
    for name, _, _ in spans:
        if name in names and (not out or out[-1] != name):
            out.append(name)
    return out


def test_annotate_is_the_shared_null_context_without_a_profiler():
    assert not profiling.enabled()
    ctx = profiling.annotate("yst.model")
    assert ctx is profiling.annotate("yst.nms")
    assert not isinstance(ctx, torch.profiler.record_function)
    with ctx:
        pass
    profiling.count("nms.pairs_swept", 5)
    profiling.count("nms.pairs_needed", torch.tensor(3))
    assert profiling.counters() == {}


def test_predict_batch_counts_nothing_without_a_profiler(predictor, monkeypatch):
    pred, x = predictor

    def no_reduction(*_):
        raise AssertionError("a counter was computed with no profiler recording")

    monkeypatch.setattr(decode, "pairs_needed", no_reduction)
    out = pred.predict_batch(x)
    assert out.shape == (B, 20, 7)
    assert profiling.counters() == {}


@pytest.mark.parametrize("halves", [False, True], ids=["predict_batch", "two_halves"])
def test_predictor_spans_in_order_nested_in_the_caller(predictor, halves):
    """Each batch records the six layers' spans once, in order, inside the
    caller's span, with ``yst.count`` between ``yst.nms`` and ``yst.pack``.
    ``forward_feats`` + ``postprocess_feats`` record the same."""
    pred, x = predictor
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function("caller"):
                if halves:
                    pred.postprocess_feats(pred.forward_feats(x))
                else:
                    pred.predict_batch(x)
    spans = _spans(prof)
    assert _sequence(spans, DEPLOY) == DEPLOY * 2
    counted = DEPLOY[:5] + ["yst.count", "yst.pack"]
    assert _sequence(spans, DEPLOY + ["yst.count"]) == counted * 2
    callers = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.name == "caller")
    assert len(callers) == 2
    for _, a, b in spans:
        assert any(c0 <= a and b <= c1 for c0, c1 in callers)
    # the sweep's geometry: every image's N(N-1)/2 pairs, N = TOPK
    c = profiling.counters()
    assert c["nms.pairs_swept"] == 2 * B * TOPK * (TOPK - 1) // 2
    assert 0 < c["nms.pairs_needed"] <= c["nms.pairs_swept"]


def _candidates(seed, n=48, batch=3, invalid=0.15):
    """Score-sorted boxes with ~``invalid`` of them invalid, and the last
    image with none valid."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((batch, n, 2), generator=g) * 50
    wh = 4 + torch.rand((batch, n, 2), generator=g) * 20
    boxes = torch.cat([xy, xy + wh], -1)
    valid = torch.rand((batch, n), generator=g) >= invalid
    valid[-1] = False
    scores = torch.linspace(1, 0.01, n).expand(batch, n).contiguous()
    labels = torch.randint(0, 3, (batch, n), generator=g, dtype=torch.int32)
    return boxes, scores, valid, labels


@pytest.mark.parametrize("single", [False, True], ids=["kernel1", "kernel2"])
def test_pairs_needed_is_the_roofline_count(single):
    """``nms.pairs_needed`` is ``benchmark.roofline.nms_tests`` of the
    sweep's keep mask before the ``max_det`` cap (here the cap binds), and
    ``nms.pairs_swept`` is B N(N-1)/2."""
    boxes, scores, valid, labels = _candidates(11)
    if single:
        boxes, scores, valid, labels = (t[:1] for t in (boxes, scores, valid, labels))
    keep_ref = nms_sweep_batched_plain(boxes, valid, 0.45)
    assert int(keep_ref[0].sum()) > 5 and valid[0].sum() < valid.shape[1]
    with profile(activities=[ProfilerActivity.CPU]):
        keep = decode._keep_batched(boxes, scores, valid, labels, iou_threshold=0.45,
                                    max_det=5, class_aware=False, nms_impl="kernel",
                                    single=single)
    assert torch.equal(keep, keep_ref & (keep_ref.cumsum(-1) <= 5))
    n = boxes.shape[1]
    assert profiling.counters() == {"nms.pairs_needed": nms_tests(keep_ref, valid),
                                    "nms.pairs_swept": boxes.shape[0] * n * (n - 1) // 2}


@pytest.fixture(scope="module")
def train_step():
    model = build_yolox("s", nc=5, ch=3, seed=2)
    state = create_train_state(model, make_optimizer())
    step = build_train_step_custom(model, yolox_loss_adapter(YOLOXLossConfig(nc=5)))
    rng = np.random.RandomState(0)
    gt = np.zeros((B, 4, 4), np.float32)
    gt[:, :2] = [[0.1, 0.1, 0.5, 0.6], [0.4, 0.3, 0.9, 0.8]]
    batch = {"img": rng.rand(B, IMG, IMG, 3).astype(np.float32),
             "gt_labels": np.array([[1, 3, 0, 0]] * B, np.int32), "gt_bboxes": gt,
             "gt_mask": np.array([[True, True, False, False]] * B)}
    return step, state, batch


def test_train_step_reports_its_phases_without_a_profiler(train_step):
    step, state, batch = train_step
    phases = []
    step.on_phase = phases.append
    try:
        step(state, batch)
    finally:
        step.on_phase = None
    assert phases == PHASES


def test_train_step_spans_each_phase_once_a_step(train_step):
    step, state, batch = train_step
    phases = []
    step.on_phase = phases.append
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                step(state, batch)
    finally:
        step.on_phase = None
    assert phases == PHASES * 2
    spans = _spans(prof, "yst.train.")
    assert [s[0] for s in spans] == [f"yst.train.{p}" for p in PHASES] * 2
    # one after the other: the step's phases do not overlap
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,single", [(3, 77, False), (128, 8400, False), (1, 512, True)],
                         ids=["kernel1", "kernel1_two_chunks", "kernel2"])
def test_counters_on_the_card(cuda, B, N, single):
    """On the card ``nms.pairs_swept`` comes from the launches (a chunked
    call counts every chunk's images) and ``nms.pairs_needed`` from the
    kernels' keep mask: both as on the CPU."""
    boxes, scores, valid, labels = (t[:B].to(cuda) for t in _candidates(B + N, N, max(B, 2)))
    keep_ref = nms_sweep_batched_plain(boxes, valid, 0.45)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        decode._keep_batched(boxes, scores, valid, labels, iou_threshold=0.45, max_det=300,
                             class_aware=False, nms_impl="kernel", single=single)
        torch.cuda.synchronize()
    assert profiling.counters() == {"nms.pairs_needed": nms_tests(keep_ref, valid),
                                    "nms.pairs_swept": B * N * (N - 1) // 2}


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_kernel_of_a_batch_falls_under_one_span(cuda, family):
    """The benchmark's trace reader: the kernels launched inside the
    caller's span are those under the six layers' spans and ``yst.count``,
    each counted once (the bf16 Predictor at 128 px)."""
    build, ch = FAMILIES[family]
    cfg = infer.PredictorConfig(img_size=128, batch_size=B, conf_threshold=0.0,
                                pre_nms_topk=TOPK, max_det=20)
    pred = infer.Predictor(build(), cfg, device=cuda)
    x = np.random.RandomState(ch).randint(0, 256, (B, 128, 128, ch), dtype=np.uint8)
    pred.predict_batch(x).cpu()
    with traced() as out:
        with record_function("bench.window"):
            for _ in range(2):
                pred.predict_batch(x).cpu()
    tr = out["trace"]
    parts = {name: tr.kernels_under(name) for name in DEPLOY + ["yst.count"]}
    assert all(parts[n] > 0 for n in DEPLOY[1:]), parts
    assert sum(parts.values()) == pytest.approx(tr.kernels_under("bench.window"), rel=1e-9)
    assert tr.spans("yst.h2d") and len(tr.spans("yst.model")) == 2
