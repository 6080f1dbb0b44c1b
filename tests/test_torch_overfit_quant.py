"""The port's end-to-end accuracy tools against the JAX package's scripts:
``yolo_scratch_tpu_torch/overfit_check.py`` against
``scripts/overfit_check.py`` and ``yolo_scratch_tpu_torch/eval_quant.py``
against ``scripts/eval_quant.py``.

Nothing of JAX compiles here: the JAX scripts run with their ``Trainer`` (or
their model loading, quantisation and loaders) replaced by stubs that
record what the script builds. Exact:

* ``overfit_check`` for YOLO11n (f32 and bf16) and YOLOX-nano: every
  ``TrainerConfig`` field the JAX package has, the model family, and the
  first train batch (shuffled) and first val batch of each loader, array
  for array; both print the same JSON keys.
* a 2-epoch CPU run of the port's ``overfit_check`` prints those keys, with
  finite values.
* ``eval_quant`` on a one-epoch 64 px checkpoint of the port's trainer,
  ``--max-batches 1``: the JSON keys of the JAX script (the variants' too),
  and the calibration and val indices it draws equal to the JAX script's.
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_scratch_tpu_torch import eval_quant, overfit_check
from yolo_scratch_tpu_torch.data.loader import Loader

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


class _Recorder:
    """A Trainer stub: records its arguments; ``fit`` returns an empty epoch."""
    seen = []

    def __init__(self, model, train_loader, val_loader, config, **kw):
        self.seen.append(dict(train=train_loader, val=val_loader, cfg=config, **kw))

    def fit(self, resume=True):
        return {"history": [{"val": {}}]}


def _first(loader):
    return next(iter(loader))


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("kind,bf16", [("yolo11", False), ("yolo11", True), ("yolox", False)])
def test_overfit_check_builds_the_jax_scripts_run(monkeypatch, capsys, kind, bf16):
    import yolo_scratch_tpu.train.trainer as jtrainer

    monkeypatch.chdir(ROOT)  # the JAX script reads its config by a relative path
    _Recorder.seen = []
    monkeypatch.setattr(jtrainer, "Trainer", _Recorder)
    monkeypatch.setattr(overfit_check, "Trainer", _Recorder)
    _script("overfit_check").main(60, bf16=bf16, model_kind=kind)
    overfit_check.main(60, bf16=bf16, model_kind=kind, device="cpu")
    ref, got = _Recorder.seen
    assert ref.get("model_kind", "yolo11") == got.get("model_kind", "yolo11") == kind
    for f in dataclasses.fields(ref["cfg"]):
        assert getattr(got["cfg"], f.name) == getattr(ref["cfg"], f.name), f.name
    for which in ("train", "val"):
        a, b = _first(ref[which]), _first(got[which])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{which} {k}")
    jax_line, port_line = _json_lines(capsys.readouterr().out)
    assert port_line.keys() == jax_line.keys()


def test_overfit_check_two_epochs_on_the_cpu(capsys):
    overfit_check.cli(["2", "--device", "cpu"])
    line = _json_lines(capsys.readouterr().out)[-1]
    assert list(line) == ["model", "final_mAP50", "final_precision", "final_recall",
                          "final_loss", "epochs", "bf16"]
    assert (line["model"], line["epochs"], line["bf16"]) == ("yolo11", 2, False)
    assert all(math.isfinite(line[k]) for k in ("final_mAP50", "final_precision",
                                                 "final_recall", "final_loss"))


def _jax_eval_quant(monkeypatch, argv):
    """The JAX script's JSON line and the loader indices it drew, its model
    loading, quantisation and evaluation stubbed."""
    import yolo_scratch_tpu.data.loader as jloader
    import yolo_scratch_tpu.infer as jinfer
    import yolo_scratch_tpu.nn.fuse as jfuse
    import yolo_scratch_tpu.nn.quant as jquant
    import yolo_scratch_tpu.train.checkpoints as jckpt

    drawn = []

    class Empty:
        def __init__(self, ds, batch_size, indices=None, **kw):
            drawn.append(np.asarray(indices))

        def __iter__(self):
            return iter(())

    monkeypatch.setattr(jloader, "Loader", Empty)
    monkeypatch.setattr(jinfer, "load_deploy_model",
                        lambda *a, **k: (None, {"params": {}, "batch_stats": {}}))
    monkeypatch.setattr(jckpt.CheckpointManager, "peek_raw", lambda self, which: None)
    monkeypatch.setattr(jquant, "quantize_for_deploy",
                        lambda model, v, calib: {**v, "quant": {}})
    monkeypatch.setattr(jquant, "count_quantized", lambda q: 0)
    monkeypatch.setattr(jfuse, "fuse_conv_bn", lambda v: v)
    return _script("eval_quant").main(argv), drawn


def test_eval_quant_prints_the_jax_keys_on_the_jax_split(tmp_path, monkeypatch, capsys):
    from yolo_scratch_tpu_torch.train import cli

    ckpt = tmp_path / "t"
    cli.main(["--device", "cpu", "--data", "synthetic", "--scale", "n", "--imgsz", "64",
              "--batch", "16", "--epochs", "1", "--ema", "--workers", "0",
              "--save-dir", str(ckpt)])
    argv = ["--data", "synthetic", "--ckpt", str(ckpt), "--imgsz", "64", "--batch", "4",
            "--max-batches", "1", "--calib-batches", "2"]
    ref, ref_drawn = _jax_eval_quant(monkeypatch, argv)

    drawn = []

    def recording(ds, batch_size, indices=None, **kw):
        drawn.append(np.asarray(indices))
        return Loader(ds, batch_size, indices=indices, **kw)

    monkeypatch.setattr(eval_quant, "Loader", recording)
    capsys.readouterr()
    got = eval_quant.main(argv + ["--device", "cpu"])
    assert _json_lines(capsys.readouterr().out)[-1] == json.loads(json.dumps(got))
    assert list(got) == list(ref)
    for variant in ("bf16", "int8"):
        assert list(got[variant]) == list(ref[variant])
        assert got[variant]["images"] == 4
    assert len(drawn) == len(ref_drawn) == 3  # calibration, then a val loader a variant
    for a, b in zip(drawn, ref_drawn):
        np.testing.assert_array_equal(a, b)
