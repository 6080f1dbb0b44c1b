"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the cells
and the metrics. Everything else lives in files of its own under
``benchmark/``, found by the names there:

* ``configs/<config>.json``: a configuration's sizes (``family`` names its
  plain reference in ``reference/nets.py``);
* ``traffic/<traffic>.json``: a traffic mix, the parameters that the
  ``driver`` it names (``drivers/<driver>.py``) and the scene generator
  (``traffic/scenes.py``) read;
* ``workloads/<cell>.json``: the limits of the cell's correctness check and
  the readings each was set from;
* ``metrics/<metric>.py``: one per-layer metric's reader.

Adding a configuration, a traffic mix, a cell or a metric adds files and
entries; no file here changes.
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
