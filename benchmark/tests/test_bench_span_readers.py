"""The readers of the program's spans and counters on a synthetic Chrome
trace: each gives the expected ms or %, and nothing where its span or
counter is missing (a program that records none, as an older one)."""

import pytest

from benchmark.spec import Spec, reader
from benchmark.trace import Trace

DEPLOY = {"normalize_ms.deploy": "yst.normalize", "model_ms.deploy": "yst.model",
          "select_ms.deploy": "yst.select", "nms_ms.deploy": "yst.nms",
          "pack_ms.deploy": "yst.pack"}
TRAIN = {"forward_kernel_ms.train": "yst.train.forward",
         "loss_kernel_ms.train": "yst.train.loss",
         "backward_kernel_ms.train": "yst.train.backward",
         "update_kernel_ms.train": "yst.train.clip_adamw_ema"}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


class _Events:
    """A trace under construction: spans, launches and their kernels."""

    def __init__(self):
        self.ev = [_span("bench.window", 0, 100_000)]
        self.corr = 0

    def span(self, name, ts, dur):
        self.ev.append(_span(name, ts, dur))

    def kernel(self, launch_ts, dur, run_ts=None):
        """A kernel launched at ``launch_ts`` (us) that runs ``dur`` us."""
        self.corr += 1
        self.ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                        "ts": launch_ts, "dur": 1, "args": {"correlation": self.corr}})
        self.ev.append({"ph": "X", "cat": "kernel", "name": f"k{self.corr}",
                        "ts": run_ts if run_ts is not None else launch_ts + 5, "dur": dur,
                        "args": {"correlation": self.corr}})

    def trace(self):
        return Trace(self.ev)


def _deploy_trace(batches=2, with_spans=True):
    """Per batch: the six spans, two kernels under each of the device ones,
    a copy under yst.h2d, and a kernel under yst.count, which no reader
    counts."""
    e = _Events()
    for b in range(batches):
        t = 1000 + b * 10_000
        if with_spans:
            e.span("yst.h2d", t, 800)
        e.ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": t + 10,
                     "dur": 700})
        for i, span in enumerate(DEPLOY.values()):
            s = t + 1000 + 1000 * i
            if with_spans:
                e.span(span, s, 500)
            e.kernel(s + 10, 100 * (i + 1))
            e.kernel(s + 400, 100 * (i + 1), run_ts=s + 3000)  # runs after the span ends
        if with_spans:
            e.span("yst.pack", t + 7000, 200)  # the second interval of yst.pack
            e.span("yst.count", t + 6000, 300)
        e.kernel(t + 7010, 50)
        e.kernel(t + 6010, 1000)
    return e.trace()


def test_deploy_span_readers():
    rec = {"trace": _deploy_trace(), "batches": 2}
    for i, name in enumerate(DEPLOY):
        want = 2 * 100 * (i + 1) / 1e3 + (0.05 if name == "pack_ms.deploy" else 0.0)
        assert reader(name).read(rec) == pytest.approx(want), name
    assert reader("h2d_host_ms.deploy").read(rec) == pytest.approx(0.8)


def test_train_span_readers_count_steps_by_the_h2d_span():
    e = _Events()
    steps = 3
    for s in range(steps):
        t = 1000 + s * 20_000
        e.span("yst.train.h2d", t, 500)
        for i, span in enumerate(TRAIN.values()):
            p = t + 1000 + 3000 * i
            e.span(span, p, 2000)
            e.kernel(p + 100, 10 * (i + 1))
            e.kernel(p + 1900, 10 * (i + 1), run_ts=p + 5000)
    e.kernel(90_000, 999)  # outside every phase
    # the driver's record holds a dict of losses under "steps" by the time readers run
    rec = {"trace": e.trace(), "steps": {"loss": [1.0]}}
    for i, name in enumerate(TRAIN):
        assert reader(name).read(rec) == pytest.approx(2 * 10 * (i + 1) / 1e3), name


@pytest.mark.parametrize("name", [*DEPLOY, "h2d_host_ms.deploy", *TRAIN])
def test_span_readers_read_nothing_without_the_span(name):
    rec = {"trace": _deploy_trace(with_spans=False), "batches": 2, "steps": 5}
    assert reader(name).read(rec) is None


def test_nms_needed_pct_reads_the_program_counters(monkeypatch):
    from yolo_scratch_tpu_torch.utils import profiling

    read = reader("nms_needed_pct.deploy").read
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read({}) is None
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"nms.pairs_needed": 3, "nms.pairs_swept": 400})
    assert read({}) == pytest.approx(0.75)


def test_each_new_reader_is_listed_in_the_cells_that_report_it():
    spec = Spec()
    deploy = {"yolo11n-crater.deploy-b128", "yolox-s-coco.deploy-b32",
              "yolo11n-crater.exact-b128"}
    for m in spec.doc["per_layer"]:
        if m["name"] in {*DEPLOY, "h2d_host_ms.deploy", "nms_needed_pct.deploy"}:
            assert set(m["workloads"]) == deploy and m["moves"] == "img_per_s"
        elif m["name"] in TRAIN:
            assert m["workloads"] == ["yolox-s-coco.train-b16"]
