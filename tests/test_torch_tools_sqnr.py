"""``yolo_scratch_tpu_torch/quant_sqnr.py`` against ``scripts/quant_sqnr.py``
on the CPU, at 64 px, B=8, two calibration batches of the synthetic set.

The JAX script runs as it is (``--cpu``), its model loading and
quantisation wrapped to record the weights (its seeded init) and the
calibration batches it used. The port's ``sqnr_rows`` runs on those
weights bridged by ``utils/weights.py::state_dict_from_jax``, on its own
loader's batches, which must equal the JAX script's exactly. Its blocks are
the JAX script's, named by module path (``model.2.cv1`` for
``model_2/cv1``), and each block's SQNR lies within 0.3 dB of the JAX
script's ``sqnr_db``, absmax and ``--quantile 0.999`` alike (both round to
0.1 dB; the two forwards and int8 convolutions sum in other orders, so an
int8 rounding may fall on the other side of .5 in a few elements).
"""

import importlib.util
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from yolo_scratch_tpu_torch import quant_sqnr
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.train.cli import make_datasets
from yolo_scratch_tpu_torch.utils.weights import _split_numeric, state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ["--imgsz", "64", "--batch", "8", "--calib-batches", "2", "--worst", "200"]
TOL_DB = 0.5  # per block
MEAN_TOL_DB = 0.1  # over the blocks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(monkeypatch, quantile):
    """The JAX script's summary, the variables it served and its calibration
    and probe batches."""
    import yolo_scratch_tpu.infer as jinfer
    import yolo_scratch_tpu.nn.quant as jquant

    spec = importlib.util.spec_from_file_location("jax_quant_sqnr",
                                                  ROOT / "scripts" / "quant_sqnr.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    load, quantize = jinfer.load_deploy_model, jquant.quantize_for_deploy

    def load_spy(*a, **k):
        model, variables = load(*a, **k)
        seen["variables"] = jax.device_get(variables)
        return model, variables

    def quantize_spy(model, variables, calib, **k):
        seen["calib"] = [np.asarray(c) for c in calib]
        return quantize(model, variables, calib, **k)

    monkeypatch.setattr(jinfer, "load_deploy_model", load_spy)
    monkeypatch.setattr(jquant, "quantize_for_deploy", quantize_spy)
    argv = ["--cpu", *FLAGS] + (["--quantile", str(quantile)] if quantile else [])
    return mod.main(argv), seen


@pytest.mark.parametrize("quantile", [None, 0.999], ids=["absmax", "q0.999"])
def test_sqnr_rows_match_the_jax_script(monkeypatch, quantile):
    ref, seen = _jax_run(monkeypatch, quantile)
    args = quant_sqnr.build_parser().parse_args(FLAGS)
    ds, ch, nc = make_datasets(Namespace(data=args.data, dataset=args.dataset,
                                         imgsz=args.imgsz))
    it = iter(Loader(ds, args.batch, prefetch=0))
    calib = [next(it)["img"] for _ in range(args.calib_batches)]
    probe = next(it)["img"]
    assert len(calib) == len(seen["calib"])
    for got, want in zip(calib, seen["calib"]):
        np.testing.assert_array_equal(got, want)

    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=ch, nc=nc, scale="n")
    model.load_state_dict(state_dict_from_jax(seen["variables"]))
    rows = quant_sqnr.sqnr_rows(model, calib, probe, quantile)
    summary = quant_sqnr.summarise(rows, quantile, args.worst)
    assert summary.keys() == ref.keys() and summary["mode"] == ref["mode"]
    assert summary["blocks"] == ref["blocks"] == len(ref["worst"]) > 50
    want = {".".join(_split_numeric(t) for t in r["block"].split("/")): r["sqnr_db"]
            for r in ref["worst"]}
    got = {r["block"]: r["sqnr_db"] for r in rows}
    assert got.keys() == want.keys()
    diffs = {k: abs(got[k] - want[k]) for k in want}
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= TOL_DB, (worst, got[worst], want[worst])
    assert np.mean(list(diffs.values())) <= MEAN_TOL_DB
    for key in ("sqnr_min_db", "sqnr_median_db"):
        assert abs(summary[key] - ref[key]) <= TOL_DB


def test_quant_sqnr_main_on_the_cpu(capsys):
    summary = quant_sqnr.main(["--cpu", "--imgsz", "64", "--batch", "2", "--worst", "3"])
    assert summary["device"]["platform"] == "cpu" and summary["blocks"] > 50
    assert len(summary["worst"]) == 3 and summary["sqnr_min_db"] <= summary["sqnr_median_db"]
    err = capsys.readouterr().err
    assert "calibration: absmax" in err and " dB  model." in err
