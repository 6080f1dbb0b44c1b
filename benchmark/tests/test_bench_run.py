"""A run's outside: no card means a non-zero exit and no result; a result
line has the contract's keys, ``check`` last; traced lines carry the
per-layer metrics and the trace's numbers."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.spec import ROOT, Spec
from small import small_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_no_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          Spec().doc["workloads"][0]["name"], "--seed", str(2**31 + 3),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout and "metrics" not in out.stdout
    assert "CUDA" in out.stderr


def test_outside_a_checkout_of_the_program_it_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the program is missing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          Spec().doc["workloads"][0]["name"], "--seed", "5", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("cell", [c["name"] for c in Spec().doc["workloads"]])
def test_result_line_keys(cell):
    line, lines, rec = small_run(cell, seconds=0.3)
    assert list(line) == KEYS
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    e2e = {m["name"] for m in Spec().metrics_for(cell, "end_to_end")}
    assert set(line["metrics"]) == e2e
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["check"]) == set(Spec().limits(cell))
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())
    assert line["correct"] is True
    # the compared numbers close standard error, each beside its limit
    assert all("<=" in x for x in lines[-len(line["check"]):])
    json.dumps(line)


def test_traced_line_keys():
    cell = "yolo11n-crater.deploy-b128"
    line, _, rec = small_run(cell, seconds=0.3, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "check"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    per = {m["name"] for m in Spec().metrics_for(cell, "per_layer")}
    # on the CPU only the host-clock readers find something to read
    assert set(line["metrics"]) <= per and "call_ms.deploy" in line["metrics"]
    assert "forward_ms.deploy" not in line["metrics"]
