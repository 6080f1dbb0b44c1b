"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the cells
and the metrics. Everything else lives in files of its own under
``benchmark/``, found by the names there:

* ``configs/<config>.json``: a configuration's sizes; its ``family`` names
  the two family files below;
* ``traffic/<traffic>.json``: a traffic mix, the parameters that the
  ``driver`` it names (``drivers/<driver>.py``) and the scene generator
  (``traffic/scenes.py``) read;
* ``workloads/<cell>.json``: the limits of the cell's correctness check and
  the readings each was set from;
* ``metrics/<metric>.py``: one per-layer metric's reader.

A family (a Python name) is two files, and everything that differs between
families goes through them:

* ``reference/<family>.py``, plain ``torch`` that imports nothing of the
  program (it may reuse ``reference/nets.py``'s blocks and
  ``reference/post.py``'s functions by relative import):

  - ``build(cfg)``: the plain model; NHWC images in [0, 1] in, a list of
    (B, ..., C) outputs out, the tensors ``check.feat_err`` compares with
    the program's model's outputs;
  - ``postprocess(cfg, maps, traffic, dtype=torch.float32)``: (packed
    (B, max_det, 7), keep (B, K), valid (B, K)) with K = 0 for a family
    without NMS (``roofline.nms_tests`` then counts 0);
  - ``trainer(model, cfg)``, for a family with train cells: the plain step,
    an object with ``step(batch) -> (loss, clipped gradients by name,
    foreground per image)`` and ``ema`` by name;
  - optionally ``seed_leaves_(model, gen)``: leaves that need a distribution
    other than ``weights.py``'s rules.

* ``programs/<family>.py``, which may import the program:

  - ``model(cfg, device)``: the program's model, built on ``meta`` and
    moved with ``to_empty``; ``weights.make_weights``' ``state_dict``
    loads into it;
  - optionally ``train_step(model, cfg, precision)``: (step, state) as the
    program's trainer builds them.

``reference.family`` and ``programs.family`` resolve them; a family that
lacks either file fails with one message naming both. ``forward_flops``
counts convs, ``Linear``, ``MultiheadAttention`` and attention blocks by
shape, and any module's own work through its ``flops(inputs, output)``.

Adding a configuration, a family, a traffic mix, a cell or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.here = self.root / "benchmark"
        self.doc = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Dict[str, Any]:
        for c in self.doc["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[c['name'] for c in self.doc['workloads']]}")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return load_json(self.here / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return load_json(self.here / "workloads" / f"{cell}.json")["limits"]

    def metrics_for(self, cell: str, kind: str) -> List[Dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
        that list it, and those without a list whose moved metric it
        reports."""
        e2e_here = {m["name"] for m in self.doc["end_to_end"]
                    if "workloads" not in m or cell in m["workloads"]}
        out = []
        for m in self.doc[kind]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e_here:
                out.append(m)
        return out


def reader(name: str, here: Path = HERE) -> ModuleType:
    """``metrics/<name>.py`` as a module (the names hold dots, so it is
    loaded by path)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
