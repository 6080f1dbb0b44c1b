"""The port's host tools against the JAX repo's scripts, and the trace
readers on traces of known sums.

* ``gen_crater_synth`` and ``gen_coco_synth``: the trees the JAX scripts
  write (run as subprocesses) and the port's, for two seeds, n=7, 64 px
  (COCO at nc=80 and nc=5), are byte-identical file for file; the port's
  readers (through ``train/cli.py::make_datasets``) give the JAX readers'
  samples exactly.
* ``ab_report``: on two ``metrics.jsonl`` files written by the port's
  Trainer, the same ``AB_RECIPE.json`` text and the same printed table as
  ``scripts/ab_report.py``.
* ``parse_trace`` and ``train_roofline`` on a hand-written Chrome trace of
  kernels, copies, launching ops (linked by external and by correlation
  IDs) and ``train_step`` ranges: every category, stage, total and span
  exact. End to end on ``--device cpu`` traces of ``profile_forward`` and
  ``profile_train``: ``parse_trace``'s total equals ``profile_forward``'s
  (1e-9 relative: one sum of the same self times in two orders), and the
  stage shares sum to 100%.
"""

import importlib.util
import json
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_scratch_tpu.train import cli as jcli
from yolo_scratch_tpu_torch import (
    ab_report,
    gen_coco_synth,
    gen_crater_synth,
    parse_trace,
    profile_forward,
    profile_train,
    train_roofline,
)
from yolo_scratch_tpu_torch.train import cli as tcli

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name, *args):
    return subprocess.run([sys.executable, str(ROOT / "scripts" / f"{name}.py"), *args],
                          capture_output=True, text=True, check=True, timeout=120).stdout


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _samples_equal(got_ds, ref_ds):
    assert len(got_ds) == len(ref_ds) > 0
    for i in range(len(ref_ds)):
        for g, r in zip(got_ds[i], ref_ds[i]):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


def _datasets(root):
    args = Namespace(data=str(root), dataset="auto", imgsz=64)
    got, ref = tcli.make_datasets(args), jcli.make_datasets(args)
    assert got[1:] == ref[1:]
    _samples_equal(got[0], ref[0])


@pytest.mark.parametrize("seed", [0, 3])
def test_gen_crater_synth_writes_the_jax_tree(tmp_path, seed, capsys):
    flags = ["--n", "7", "--img-size", "64", "--seed", str(seed)]
    ref_out = _run_script("gen_crater_synth", "--out", str(tmp_path / "jax"), *flags)
    gen_crater_synth.main(["--out", str(tmp_path / "port"), *flags])
    got, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(ref) == 7 + 3 and got == ref
    assert capsys.readouterr().out.replace("port", "jax") == ref_out
    _datasets(tmp_path / "port")


@pytest.mark.parametrize("seed,nc", [(0, 80), (3, 5)])
def test_gen_coco_synth_writes_the_jax_tree(tmp_path, seed, nc, capsys):
    flags = ["--n", "7", "--img-size", "64", "--nc", str(nc), "--seed", str(seed)]
    ref_line = json.loads(_run_script("gen_coco_synth", "--out", str(tmp_path / "jax"), *flags))
    line = gen_coco_synth.main(["--out", str(tmp_path / "port"), *flags])
    got, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(ref) == 7 + 1 and got == ref
    assert json.loads(capsys.readouterr().out) == line
    assert {**line, "out": ref_line["out"]} == ref_line
    _datasets(tmp_path / "port")


def test_ab_report_writes_the_jax_summary(tmp_path, capsys, monkeypatch):
    runs = []
    for name, lr in (("a", "0.01"), ("b", "0.002")):
        runs.append(str(tmp_path / name))
        tcli.main(["--device", "cpu", "--data", "synthetic", "--scale", "n", "--imgsz", "64",
                   "--batch", "8", "--epochs", "3", "--workers", "0", "--lr", lr,
                   "--val-conf", "0.01", "--save-dir", runs[-1]])
    rows = ab_report.load(runs[0])
    assert len(rows) == 3 and {"val/mAP50", "val/mAP50-95"} <= set(rows[0])
    flags = ["--a", runs[0], "--b", runs[1], "--every", "2"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["ab_report.py", *flags, "--out", str(tmp_path / "jax.json")])
    _script("ab_report").main()  # the script parses sys.argv
    ref_out = capsys.readouterr().out
    summary = ab_report.main([*flags, "--out", str(tmp_path / "port.json")])
    assert capsys.readouterr().out == ref_out
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert summary == json.loads((tmp_path / "jax.json").read_text())


# ------------------------------------------------------------ trace readers

def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1 if "cpu" in cat else 7,
            "ts": ts, "dur": dur, "args": args}


def _hand_trace(iters=2):
    """``iters`` train steps at B=4, 640 px, G=24: each a ``train_step``
    range on both timelines, eight kernels (one per stage, one linked only
    through its runtime launch's correlation ID, one with no op), a memcpy
    and a memset."""
    ev = []
    for i in range(iters):
        t = 10_000.0 * i
        ops = [  # (op, input dims, kernel, kernel us)
            ("aten::cudnn_convolution", [[4, 16, 160, 160], [32, 16, 3, 3]],
             "sm90_xmma_fprop_implicit_gemm_bf16_kernel", 100.0),
            ("aten::sub", [[4, 8400, 69], []],
             "void at::native::vectorized_elementwise_kernel<4, at::native::Sub<float> >(int)",
             20.0),
            ("aten::mul", [[4, 8400, 24], [4, 8400, 24]],
             "void at::native::elementwise_kernel<128, 2, Mul>(int)", 15.0),
            ("aten::gt", [[4, 24], []],
             "void at::native::vectorized_elementwise_kernel<4, Gt>(int)", 5.0),
            ("aten::_foreach_add_", [[[16, 1, 3, 3], [16]], [[16, 1, 3, 3], [16]]],
             "void at::native::multi_tensor_apply_kernel<Add>(int)", 7.5),
            ("aten::contiguous", [[4, 32, 80, 80]],
             "void cudnn::engines_precompiled::nhwcToNchwKernel<float>(int)", 3.0),
            ("aten::add", [[4, 512, 4096], [4, 512, 4096]],
             "void at::native::vectorized_elementwise_kernel<4, Add>(int)", 2.0),
        ]
        ev.append(_x("user_annotation", "train_step", t, 900.0))
        ev.append(_x("gpu_user_annotation", "train_step", t + 5, 400.0))
        for j, (op, dims, kernel, us) in enumerate(ops):
            ext, corr = 100 * i + j + 1, 1000 * i + j + 1
            ev.append(_x("cpu_op", op, t + 10 + 10 * j, 5.0, **{"External id": ext,
                                                               "Input Dims": dims}))
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", t + 11 + 10 * j, 2.0,
                         **{"External id": ext, "correlation": corr}))
            kargs = {"correlation": corr} if j == 1 else {"External id": ext,
                                                          "correlation": corr}
            ev.append(_x("kernel", kernel, t + 100 + 30 * j, us, **kargs))
        ev.append(_x("kernel", "nms_iou_mask_kernel", t + 400, 1.5, correlation=999_999))
        ev.append(_x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 50, 40.0))
        ev.append(_x("gpu_memset", "Memset (Device)", t + 60, 2.0))
    return {"traceEvents": ev, "yst_run": {"batch": 4, "imgsz": 640, "gt": 24, "iters": iters},
            "yst_device": {"platform": "gpu", "kind": "test", "count": 1, "power_limit": None}}


def _write(tmp_path, trace, name="hand.pt.trace.json"):
    (tmp_path / name).write_text(json.dumps(trace))
    return tmp_path


def test_parse_trace_sums_a_hand_written_trace(tmp_path, capsys):
    d = _write(tmp_path, _hand_trace())
    s = parse_trace.main(["--dir", str(d), "--iters", "2", "--asyncs"])
    assert s["source"] == "device kernels" and s["events"] == 16 and s["copy_events"] == 4
    assert s["total_ms"] == pytest.approx(2 * 154.0 / 1e3, rel=1e-12)
    assert s["ms_per_iter"] == pytest.approx(0.154, rel=1e-12)
    assert s["copy_ms_per_iter"] == pytest.approx(0.042, rel=1e-12)
    assert s["categories"] == pytest.approx({
        "sm90_xmma_fprop_implicit_gemm_bf16_kernel": 0.1,
        "vectorized_elementwise_kernel": 0.027, "elementwise_kernel": 0.015,
        "multi_tensor_apply_kernel": 0.0075, "layout-copy": 0.003,
        "nms_iou_mask_kernel": 0.0015}, rel=1e-12)
    assert s["device"]["kind"] == "test"
    out = capsys.readouterr().out
    assert "copy/dma" in out and "Memcpy HtoD" in out


def test_train_roofline_stages_a_hand_written_trace(tmp_path):
    d = _write(tmp_path, _hand_trace())
    r = train_roofline.main(["--dir", str(d), "--iters", "2"])
    assert r["step_ms_per_iter"] == pytest.approx(0.4, rel=1e-12)  # the GPU span
    assert r["stages_ms_per_iter"] == pytest.approx({
        "model spatial (fwd+bwd)": 0.1, "head/loss per-anchor": 0.02, "TAL (B,A,G)": 0.015,
        "GT preprocess": 0.005, "param-shaped (wgrad+opt)": 0.0075, "layout/copy": 0.003,
        "other": 0.0035, "copy/dma": 0.042}, rel=1e-12)
    assert sum(r["shares_pct"].values()) == pytest.approx(100.0, abs=1e-9)


def test_cpu_self_times_subtract_nested_ops():
    trace = {"traceEvents": [_x("cpu_op", "outer", 0, 10.0), _x("cpu_op", "inner", 2, 3.0),
                             _x("cpu_op", "inner2", 6, 1.0), _x("cpu_op", "next", 20, 4.0)]}
    got = {e["name"]: us for e, us in parse_trace.cpu_self_times(trace)}
    assert got == {"outer": 6.0, "inner": 3.0, "inner2": 1.0, "next": 4.0}


def test_profilers_and_readers_end_to_end_on_the_cpu(tmp_path):
    fwd = profile_forward.main(["--device", "cpu", "--batch", "2", "--imgsz", "64", "--full",
                                "--iters", "2", "--top", "5"], out_dir=tmp_path / "fwd")
    assert fwd["device"]["platform"] == "cpu" and fwd["events"] > 0
    assert np.isfinite(fwd["valid_per_image"])
    s = parse_trace.main(["--dir", str(tmp_path / "fwd"), "--iters", "2"])
    assert s["source"] == "cpu ops" and s["device"] == fwd["device"]
    assert s["total_ms"] == pytest.approx(fwd["total_ms"], rel=1e-9)
    tr = profile_train.main(["--device", "cpu", "--batch", "2", "--imgsz", "64", "--iters",
                             "2", "--scan", "2"], out_dir=tmp_path / "train")
    assert np.isfinite(tr["loss"]) and tr["scan"] == 2 and tr["step_ms"] > 0
    r = train_roofline.main(["--dir", str(tmp_path / "train"), "--iters", "2"])
    assert r["step_ms_per_iter"] > 0 and r["source"] == "cpu ops"
    assert sum(r["shares_pct"].values()) == pytest.approx(100.0, abs=1e-9)
    assert r["stages_ms_per_iter"]["model spatial (fwd+bwd)"] > 0


@pytest.mark.parametrize("module", [profile_forward, profile_train])
def test_profilers_default_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        module.main(["--batch", "1", "--imgsz", "64", "--iters", "1"])
