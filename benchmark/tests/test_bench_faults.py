"""The rest of a run, with the timed path broken underneath, comes out not
correct: once for each fault a cell can have. The harness's look for a card
is skipped (CPU, small sizes, the program's plain paths)."""

import pytest
import torch

from benchmark.faults import DEPLOY_FAULTS, TRAIN_FAULTS
from small import f32_predictor, small_run

DEPLOY = ["yolo11n-crater.deploy-b128", "yolox-s-coco.deploy-b32", "yolo11n-crater.exact-b128"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", sorted(DEPLOY_FAULTS))
@pytest.mark.parametrize("cell", DEPLOY)
def test_deploy_fault_is_caught(cell, fault):
    wrap = DEPLOY_FAULTS[fault]
    line, lines, _ = small_run(cell, seconds=0.3,
                               make_predictor=lambda m, c, d: wrap(f32_predictor(m, c, d)))
    assert line["correct"] is False, lines


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_is_caught(fault):
    line, lines, _ = small_run("yolox-s-coco.train-b16", seconds=0.3,
                               make_step=TRAIN_FAULTS[fault])
    assert line["correct"] is False, lines


@pytest.mark.parametrize("cell", DEPLOY + ["yolox-s-coco.train-b16"])
def test_sound_runs_are_correct(cell):
    line, lines, _ = small_run(cell, seconds=0.3)
    assert line["correct"] is True, lines
