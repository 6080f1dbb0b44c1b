"""The yardstick's arithmetic: the forward's FLOP count against the port's
``utils/model_info.py`` (``FlopCounterMode``), and greedy NMS's operations
and bytes on a hand-worked case."""

import pytest
import torch

from benchmark import roofline
from benchmark.reference import nets
from benchmark.spec import Spec


@pytest.mark.parametrize("config", ["yolo11n-crater", "yolox-s-coco"])
def test_forward_flops_match_the_flop_counter(config):
    from yolo_scratch_tpu_torch.utils.model_info import model_info

    torch.manual_seed(0)
    cfg = Spec().config(config)
    model = nets.build(cfg).eval()
    S = 128
    ours = roofline.forward_flops(model, torch.zeros(1, S, S, cfg["ch"]))
    theirs = model_info(model, img_size=S, channels=cfg["ch"])["gflops"] * 1e9
    # both count every tap of every conv, the padding's too, and attention's
    # two products: the counts agree within a part in a thousand
    assert abs(ours / theirs - 1) < 1e-3, (ours, theirs)


#: forward FLOPs an image at 640, as counted before ``Linear``,
#: ``MultiheadAttention`` and ``flops`` methods had rules (PERF.md's counts)
FLOPS_640 = {"yolo11n-crater": 8_220_416_000, "yolox-s-coco": 26_685_542_400}


@pytest.mark.parametrize("config", sorted(FLOPS_640))
def test_forward_flops_at_640_are_the_earlier_count(config):
    cfg = Spec().config(config)
    with torch.device("meta"):  # shapes are all the count reads
        model = nets.build(cfg)
    x = torch.zeros(1, 640, 640, cfg["ch"], device="meta")
    assert roofline.forward_flops(model, x) == FLOPS_640[config]


def test_nms_tests_hand_worked():
    # four score-sorted boxes, all valid; 0 kept (3 valid after it), 1
    # suppressed, 2 kept (1 after), 3 kept (none after): 4 tests
    keep = torch.tensor([[True, False, True, True]])
    valid = torch.ones(1, 4, dtype=torch.bool)
    assert roofline.nms_tests(keep, valid) == 4
    # an invalid box after a pivot is not tested
    valid2 = torch.tensor([[True, True, False, True]])
    keep2 = torch.tensor([[True, False, False, True]])
    assert roofline.nms_tests(keep2, valid2) == 2


def test_nms_least_time_bounds():
    t, by = roofline.nms_least_seconds(tests=10**6, boxes=512)
    assert by == "ops" and t == pytest.approx(14e6 / 67e12)
    t, by = roofline.nms_least_seconds(tests=0, boxes=512)
    assert by == "bytes" and t == pytest.approx(512 * 18 / 3.35e12)
