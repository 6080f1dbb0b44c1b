"""The controls come out not correct (on the card: cuDNN's bf16 and TF32
arithmetic has no CPU stand-in). ``benchmark/control.py`` reads them at the
cells' own sizes on a dozen seeds; these tests hold each at a size a test
run can hold. Run on the card: ``python -m pytest benchmark/tests -m gpu``."""


import pytest
import torch

from benchmark import control
from benchmark.drivers import deploy, train
from benchmark.spec import Spec

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls' arithmetic is cuDNN's")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["yolo11n-crater.deploy-b128", "yolox-s-coco.deploy-b32",
                                  "yolo11n-crater.exact-b128"])
def test_deploy_controls_fail(cell, cuda):
    spec = Spec()
    c = spec.cell(cell)
    cfg = spec.config(c["config"])
    traffic = dict(spec.traffic(c["traffic"]), batch=16, pool=2)
    limits = spec.limits(cell)
    row = control.deploy_row(deploy, cfg, traffic, 2**31 + 17, 0.5, cuda, True)
    assert row["program"]["feat_err"] <= limits["feat_err"]
    assert row["program"]["post_mismatch"] <= limits["post_mismatch"]
    assert row["int8"]["feat_err"] > limits["feat_err"]
    assert row["program"]["post_mismatch.bf16"] > limits["post_mismatch"]


def test_train_control_fails(cuda):
    spec = Spec()
    cell = "yolox-s-coco.train-b16"
    c = spec.cell(cell)
    cfg = spec.config(c["config"])
    traffic = dict(spec.traffic(c["traffic"]), batch=8, pool=4)
    limits = spec.limits(cell)
    row = control.train_row(train, cfg, traffic, 2**31 + 17, cuda, True)
    assert all(row["program"][k] <= v for k, v in limits.items())
    assert any(row["tf32"][k] > v for k, v in limits.items())
