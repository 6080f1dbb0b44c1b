"""Run from the root of a checkout that holds the toy family: one small CPU
run of its cell through a stand-in predictor, and its FLOPs by
``roofline.forward_flops`` and by ``FlopCounterMode``; prints one JSON
line."""

import json
import sys

import torch

sys.path[:0] = [".", "benchmark/tests"]  # the checkout first, then its small.py

from small import small_run  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from benchmark import roofline  # noqa: E402
from benchmark.reference import nets, toy  # noqa: E402
from benchmark.spec import Spec  # noqa: E402

CELL = "toy-det.deploy-b32"


class StandIn:
    """The deploy entry the driver expects, on the toy model: f32 maps,
    then the toy's postprocess."""

    def __init__(self, model, pcfg, device):
        self.model, self.device = model.eval(), device
        self.traffic = {"img_size": pcfg.img_size, "conf": pcfg.conf_threshold,
                        "max_det": pcfg.max_det}

    def forward_feats(self, x):
        with torch.no_grad():
            return self.model(torch.as_tensor(x).to(self.device).float() / 255.0)

    def postprocess_feats(self, feats):
        return toy.postprocess(None, feats, self.traffic)[0]

    def predict_batch(self, x):
        return self.postprocess_feats(self.forward_feats(x))


torch.set_num_threads(2)
spec = Spec()
line, lines, rec = small_run(CELL, seconds=0.3, make_predictor=StandIn, spec=spec)
cfg = spec.config("toy-det")
ref = nets.build(cfg).eval()
x = torch.zeros(1, 64, 64, cfg["ch"])
with FlopCounterMode(display=False) as counter:  # as utils/model_info.py counts
    ref(x)
print("\n".join(lines), file=sys.stderr)
print(json.dumps({"line": line, "flops": roofline.forward_flops(ref, x),
                  "flop_counter": counter.get_total_flops(),
                  "flops_per_image": rec["flops_per_image"]}))
