"""The port's benches (``yolo_scratch_tpu_torch/bench/``) on the CPU.

* The headline's timed program (``bench/headline.py::deploy_program``) at
  64 px, B=2, nscan 2, f32 and conf 0 (every anchor a candidate), on both
  rows, against the JAX package's ``bench.py`` program built the same way
  (``fuse_conv_bn`` + ``model.apply`` + ``postprocess_from_feats(...,
  nms_impl="xla", blocked_topk=0)``) on the JAX init carried over by
  ``state_dict_from_jax``. Keep sets, labels and valid masks exact; scores
  and normalised boxes within ``atol = 1e-5``, the f32 Predictor tolerance
  of ``tests/test_torch_infer.py`` (the two forwards sum conv products in
  other orders, ~1e-6 relative).
* Every bench's ``main`` at a tiny size with ``--device cpu``: its JSON line
  holds its JAX script's keys and says ``"platform": "cpu"``; without a
  card, each one's default device raises.
* ``bench/eval.py``: the device matching's mAP50-95 equals the host
  matcher's exactly, on 16 images of a model whose scores pass the gate,
  and so does the device's marks accumulated as the host accumulates; a
  TP and an FP that tie on score are ordered differently by the two
  accumulations (the JAX package's as well), and a seeded case shows it.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from yolo_scratch_tpu.ops.decode import postprocess_from_feats as jax_postprocess_from_feats
from yolo_scratch_tpu_torch.bench import (
    breakdown,
    e2e,
    eval as bench_eval,
    export,
    headline,
    ingest,
    int8_scales,
    latency,
    scale,
    serving,
)
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

IMG, B, NSCAN = 64, 2, 2
JAX_CFG = str(CONFIGS.parent.parent / "yolo_scratch_tpu/configs/yolo11_crater.yaml")
ROWS = [("crater", 1, 5), ("coco", 3, 80)]
ANCHORS = sum((IMG // s) ** 2 for s in (8, 16, 32))  # every one a candidate at conf 0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_program(jm, variables, nc):
    """``bench.py``'s ``infer_one`` in f32 at conf 0, jitted."""
    def infer_one(v, x):
        feats = jm.apply(v, x.astype(jnp.float32) / 255.0, train=False)
        return jax_postprocess_from_feats(
            feats, nc=nc, strides=tuple(float(s) for s in jm.strides), img_size=IMG,
            conf_threshold=0.0, iou_threshold=0.45, max_det=300, pre_nms_topk=512,
            nms_impl="xla", blocked_topk=0)
    return jax.jit(infer_one)


@pytest.mark.parametrize("row,ch,nc", ROWS, ids=[r[0] for r in ROWS])
def test_headline_program_matches_jax_bench(row, ch, nc):
    jm = jax_build(JAX_CFG, ch=ch, nc=nc, scale="n")
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), np.zeros((1, IMG, IMG, ch),
                                                                        np.float32)))
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=ch, nc=nc, scale="n")
    model.load_state_dict(state_dict_from_jax(variables))
    _, program = headline.deploy_program(model, B, 512, "cpu", dtype=torch.float32, conf=0.0,
                                         img=IMG)
    xs = np.random.RandomState(ch).randint(0, 256, (NSCAN, B, IMG, IMG, ch), dtype=np.uint8)
    got = program(torch.from_numpy(xs))
    ref_fn, fused = _jax_program(jm, variables, nc), jax_fuse(variables)
    assert len(got) == NSCAN
    for g, x in zip(got, xs):
        boxes, scores, labels, valid = (np.asarray(a) for a in ref_fn(fused, x))
        gb, gs, gl, gv = (t.numpy() for t in g)
        assert gb.shape == boxes.shape == (B, 300, 4)
        np.testing.assert_array_equal(gv, valid)
        np.testing.assert_array_equal(gl, labels)
        np.testing.assert_allclose(gs, scores, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, boxes, rtol=0, atol=1e-5)
        kept = valid.sum(1)
        assert kept.min() >= 3 and kept.max() < ANCHORS  # NMS kept some and dropped some


# bench module, argv at a tiny size, the JAX script's keys (file:line of its JSON)
BENCHES = {
    # bench.py:145-166
    "headline": (headline.main, [], ["metric", "value", "unit", "vs_baseline", "pre_nms_topk",
                                     "batch", "nscan", "coco_shaped"]),
    # scripts/bench_latency.py:106-110, 125-127 (the tunnel note is TPU-only)
    "latency": (latency.main, ["--imgsz", "64", "--iters", "2", "--launches", "2"],
                ["scale", "imgsz", "device_latency_ms", "launch_p50_ms", "launch_p99_ms"]),
    # scripts/bench_scale.py:117-121
    "scale": (scale.main, ["--scale", "n", "--batch", "2", "--nscan", "1", "--imgsz", "64"],
              ["model", "scale", "batch", "imgsz", "params", "images_per_sec_per_chip"]),
    "scale_yolox": (scale.main, ["--model", "yolox", "--scale", "n", "--batch", "2", "--nscan",
                                 "1", "--imgsz", "64"],
                    ["model", "scale", "batch", "imgsz", "params", "images_per_sec_per_chip"]),
    # scripts/bench_breakdown.py:107-117 (FLOPs under the port's own keys)
    "breakdown": (breakdown.main, ["--batch", "2", "--imgsz", "64", "--iters", "1"],
                  ["forward_ms", "forward_decode_ms", "full_ms", "postprocess_ms",
                   "decode_ms_est", "batch", "imgsz", "full_imgs_per_sec",
                   "forward_imgs_per_sec", "flops_per_batch", "h100_bf16_peak_pct"]),
    # scripts/bench_export.py:97-103
    "export": (export.main, ["--batch", "2", "--nscan", "1"],
               ["metric", "live", "artifact", "ratio", "artifact_mb", "batch"]),
    # scripts/bench_int8_scales.py:97-103 (rows), 129-132
    "int8_scales": (int8_scales.main, ["--scales", "n", "--batch", "2", "--nscan", "1",
                                       "--imgsz", "64"], ["rows", "summary", "protocol"]),
    # scripts/bench_e2e.py:106-110
    "e2e": (e2e.main, ["--n", "4", "--src", "96", "--imgsz", "64", "--batch", "2"],
            ["n", "src", "imgsz", "batch", "scale", "note", "rows"]),
    # scripts/bench_serving.py:177-178, 118-133
    "serving": (serving.main, ["--imgsz", "64", "--batch", "2", "--src-px", "96", "--clients",
                               "2", "--wait-ms", "1", "--duration", "0.5", "--n-images", "2"],
                ["imgsz", "batch", "src_px", "rows"]),
    # scripts/bench_eval.py:168-190
    "eval": (bench_eval.main, ["--images", "4", "--batch", "2", "--imgsz", "64"],
             ["images", "nc", "imgsz", "batch", "device_path", "host_path",
              "agreement_mAP50_95"]),
    # scripts/bench_ingest.py:65-66 (the native tier, which builds here)
    "ingest": (ingest.cli, ["4", "96"],
               ["noise_png_uint8_img_per_s", "noise_png_float32_img_per_s",
                "noise_jpeg_uint8_fastscale_img_per_s", "smooth_jpeg_float32_img_per_s",
                "n", "src_size", "dst_size", "note"]),
    # scripts/bench_ingest.py:113-114
    "ingest_loader": (ingest.cli, ["loader", "4", "96", "64"],
                      ["workers_0_img_per_s", "workers_8_img_per_s", "n", "src_size",
                       "dst_size"]),
}
NESTED = {"headline": ("coco_shaped", ["metric", "value", "unit", "vs_baseline"]),
          "serving": ("rows", ["clients", "wait_ms", "completed", "errors", "achieved_img_s",
                               "latency_ms", "batches", "batch_fill", "server_latency_ms"]),
          "e2e": ("rows", ["fmt", "fast_jpeg", "inflight", "img_per_s", "wall_s"]),
          "int8_scales": ("rows", ["scale", "dtype", "batch", "imgsz",
                                   "images_per_sec_per_chip", "compile_s"]),
          "eval": ("device_path", ["dispatch_s", "eval_total_s", "host_ap_accumulation_s",
                                   "host_per_class_accumulation_s", "images_per_sec",
                                   "host_fraction"])}


@pytest.fixture
def tiny(monkeypatch):
    """One launch a window, and the two benches without size flags
    (``bench.py`` and ``scripts/bench_export.py`` fix 640) at 64 px."""
    for mod in (headline, export, scale, int8_scales):
        monkeypatch.setattr(mod, "ITERS", 1)
    for mod in (headline, export):
        monkeypatch.setattr(mod, "IMG", IMG)
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("BENCH_NSCAN", "1")


@pytest.mark.parametrize("name", list(BENCHES))
def test_bench_prints_jax_keys_on_cpu(name, tiny, capsys):
    main, argv, keys = BENCHES[name]
    result = main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    missing = [k for k in keys if k not in line]
    assert not missing, missing
    if name in NESTED:
        key, sub = NESTED[name]
        inner = line[key][0] if isinstance(line[key], list) else line[key]
        assert not [k for k in sub if k not in inner], inner
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1


@pytest.mark.parametrize("name", list(BENCHES))
def test_bench_default_device_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv, _ = BENCHES[name]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(argv)


def _scoring_model():
    """COCO-shaped YOLO11n whose scores pass conf 0.001: random BN
    statistics and zeroed class-bias priors (``tests/test_torch_infer.py``)."""
    model = build_yolo11(CONFIGS / "yolo11_coco.json", ch=3, nc=80, scale="n", seed=3)
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.3, 0.8, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
        for cls in model.model[-1].cv3:
            cls[2].bias.zero_()
    return model


def test_eval_device_and_host_map_agree_exactly():
    """Random ground truth would match nothing, and an mAP of 0 on both
    paths would prove nothing: the GT sits near the detections."""
    model = _scoring_model()
    batches = bench_eval.batches_near_detections(model, range(2), 8, 64, 80, 24)
    out = bench_eval.run(model, images=16, batch=8, imgsz=64, nc=80, per_class_host=False,
                         batches=batches)
    assert out["images"] == 16 and out["detections_per_image"] >= 4
    agree = out["agreement_mAP50_95"]
    assert 0.05 < agree["host"] < 0.95
    assert agree["marks_host_ap"] == agree["host"]  # the device's marks are the host's
    assert out["tp_fp_score_ties"] == 0 and agree["device"] == agree["host"]


def test_eval_reports_where_tied_scores_part_device_from_host():
    """A TP and an FP on one score: ``metrics_from_marks`` keeps them in
    detection order, ``calculate_ap`` puts the TP first; ``marks_host_ap``
    accumulates the device's marks as the host does and equals it. Two
    images, one GT each, the same score on an FP in image 0 and a TP in
    image 1."""
    marks = np.zeros((2, 10, 2), bool)
    marks[1, :, 0] = True  # image 1's first detection is a TP at every threshold
    scores = np.array([[0.9, 0.5], [0.9, 0.1]], np.float32)
    valid = np.array([[True, False], [True, False]])
    by_host, ties = bench_eval.marks_host_ap(marks, scores, valid, n_gt=2)
    assert ties == 2
    assert by_host == pytest.approx(0.5, abs=1e-5)  # TP first: precision 1 to recall 0.5
    device = bench_eval.metrics_from_marks(marks, scores, valid, 2)["mAP50-95"]
    assert device == pytest.approx(0.25, abs=1e-5)  # FP first: precision 0.5 at recall 0.5
