"""BENCHMARK.json against the contract's shape, and every file it names
found by name; a new configuration, mix, cell, metric and model family are
picked up from new files and entries alone."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import programs, reference
from benchmark.spec import ROOT, Spec, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    d = Spec().doc
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["benchmark"] and len(d["command"]) <= 32
    assert 1 <= d["run_seconds"] <= 51 and isinstance(d["run_seconds"], int)
    assert 2 + 14 * 24 <= 43200  # the full check with 24 cells fits
    assert (2 + 14 * 24) * (d["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(d)) <= 64 * 1024


def test_entries_follow_the_contract():
    d = Spec().doc
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in d[k]}) == len(d[k])
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    cells = {c["name"] for c in d["workloads"]}
    assert len(cells) <= 24
    assert len({(c["config"], c["traffic"]) for c in d["workloads"]}) == len(cells)
    for c in d["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1 and 1 <= len(c["why"]) <= 200
    assert {c["config"] for c in d["workloads"]} == {c["name"] for c in d["configs"]}
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and UNIT.match(m["unit"])
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
    spec = Spec()
    for cell in cells:
        reported = {m["name"] for m in spec.metrics_for(cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_for(cell, "per_layer")


@pytest.mark.parametrize("cell", [c["name"] for c in Spec().doc["workloads"]])
def test_each_cell_finds_its_files(cell):
    spec = Spec()
    c = spec.cell(cell)
    cfg, traffic, limits = spec.config(c["config"]), spec.traffic(c["traffic"]), spec.limits(cell)
    ref, prog = reference.family(cfg), programs.family(cfg)
    assert callable(ref.build) and callable(ref.postprocess) and callable(prog.model)
    if traffic["driver"] == "train":
        assert callable(ref.trainer) and callable(prog.train_step)
    else:
        assert traffic["driver"] == "deploy"
    assert limits and all(v > 0 for v in limits.values())
    for m in spec.metrics_for(cell, "per_layer"):
        assert callable(reader(m["name"]).read)


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A later PR's configuration, mix, cell and metric: new files and new
    entries, no file changed."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/yolo11n-crater.json").read_text())
    cfg["name"] = "yolo11s-crater"
    cfg["scales"] = {"s": [0.5, 0.5, 1024]}
    cfg["scale"], cfg["width_multiple"] = "s", 0.5
    (root / "benchmark/configs/yolo11s-crater.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/deploy-b32.json").read_text())
    (root / "benchmark/traffic/deploy-b64.json").write_text(json.dumps(dict(mix, batch=64)))
    (root / "benchmark/workloads/yolo11s-crater.deploy-b64.json").write_text(
        json.dumps({"limits": {"feat_err": 1.0, "post_mismatch": 1.0}}))
    (root / "benchmark/metrics/batches.deploy.py").write_text(
        "def read(rec):\n    return rec.get('batches')\n")
    d["configs"].append({"name": "yolo11s-crater", "source": "x", "why": "x", "reduced": [],
                         "file": "benchmark/configs/yolo11s-crater.json"})
    d["workloads"].append({"name": "yolo11s-crater.deploy-b64", "config": "yolo11s-crater",
                           "traffic": "deploy-b64", "chips": 1, "why": "x"})
    for m in d["end_to_end"]:
        if "workloads" in m and "yolo11n-crater.deploy-b128" in m["workloads"]:
            m["workloads"].append("yolo11s-crater.deploy-b64")
    d["per_layer"].append({"name": "batches.deploy", "unit": "1", "better": "higher",
                           "source": "host_clock", "layer": "x", "moves": "img_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    spec = Spec(root)
    assert spec.config("yolo11s-crater")["scale"] == "s"
    assert spec.traffic("deploy-b64")["batch"] == 64
    assert spec.limits("yolo11s-crater.deploy-b64")["feat_err"] == 1.0
    per = [m["name"] for m in spec.metrics_for("yolo11s-crater.deploy-b64", "per_layer")]
    assert "batches.deploy" in per
    assert reader("batches.deploy", spec.here).read({"batches": 7}) == 7
    # a metric without a workloads list reaches every cell reporting its moved metric
    assert "batches.deploy" in [m["name"] for m in
                                spec.metrics_for("yolo11n-crater.deploy-b128", "per_layer")]


def test_a_family_without_its_files_fails_naming_both():
    for fam in ("nosuch", "nets"):
        with pytest.raises(LookupError) as e:
            reference.family({"family": fam})
        assert f"benchmark/reference/{fam}.py" in str(e.value)
        assert f"benchmark/programs/{fam}.py" in str(e.value)
        with pytest.raises(LookupError, match=f"benchmark/programs/{fam}.py"):
            programs.family({"family": fam})


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_joins_through_new_files(tmp_path):
    """A family the harness has never seen (``tests/toy/``: an NMS-free
    detector with a ``Linear``, a ``LayerNorm``, a ``MultiheadAttention``,
    bare parameters and a module counting its own FLOPs) joins a copy of the
    benchmark through new files and new entries alone; a small CPU run of
    its cell through a stand-in predictor comes out correct, and its FLOPs
    are ``FlopCounterMode``'s."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    before = _digests(root)
    toy = ROOT / "benchmark/tests/toy"
    b = root / "benchmark"
    shutil.copy(toy / "reference.py", b / "reference/toy.py")
    shutil.copy(toy / "program.py", b / "programs/toy.py")
    shutil.copy(toy / "config.json", b / "configs/toy-det.json")
    shutil.copy(toy / "limits.json", b / "workloads/toy-det.deploy-b32.json")
    d = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(d))
    d["configs"].append({"name": "toy-det", "source": "x", "why": "x", "reduced": [],
                         "file": "benchmark/configs/toy-det.json"})
    d["workloads"].append({"name": "toy-det.deploy-b32", "config": "toy-det",
                           "traffic": "deploy-b32", "chips": 1, "why": "x"})
    for m in d["end_to_end"] + d["per_layer"]:
        if "yolox-s-coco.deploy-b32" in m.get("workloads", []):
            m["workloads"].append("toy-det.deploy-b32")
    (root / "BENCHMARK.json").write_text(json.dumps(d))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "benchmark/tests/toy/drive.py"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["line"]["correct"] is True, out.stderr[-4000:]
    assert res["line"]["check"]["post_mismatch"]["value"] == 0.0
    assert res["flops"] == res["flop_counter"] > 0
    # the run counted the same FLOPs at the traffic's image side (64 in the small run)
    assert res["flops_per_image"] == res["flops"]
    # no file that was there changed; BENCHMARK.json only gained entries
    after = _digests(root)
    assert {k: after[k] for k in before if k.name != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k.name != "BENCHMARK.json"}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for was, now in zip(old[key], d[key]):
            assert {k: v for k, v in now.items() if k != "workloads"} == \
                {k: v for k, v in was.items() if k != "workloads"}
            assert now.get("workloads", [])[:len(was.get("workloads", []))] == \
                was.get("workloads", [])
