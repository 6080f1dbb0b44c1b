"""Nothing under benchmark/ imports JAX or the JAX package (top-level
module names compared whole: ``yolo_scratch_tpu_torch`` is not
``yolo_scratch_tpu``), and the plain reference imports nothing of the
program."""

import ast
import subprocess
import sys

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.spec import ROOT

BENCH = ROOT / "benchmark"


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def relative_import_levels(path):
    return {node.level for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) and node.level > 0}


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    """The reference's files import torch, numpy, the standard library's
    plain modules and each other (relative imports that stay inside
    ``reference/``): nothing of the program and nothing of ``programs/``."""
    for path in (BENCH / "reference").rglob("*.py"):
        assert "yolo_scratch_tpu_torch" not in top_level_imports(path), path
        assert top_level_imports(path) <= {"__future__", "contextlib", "importlib", "math",
                                           "pathlib", "types", "typing", "numpy",
                                           "torch"}, path
        assert relative_import_levels(path) <= {1}, path


def test_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "yolo_scratch_tpu_torch_extra", sys)
    assert "yolo_scratch_tpu_torch_extra" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "yolo_scratch_tpu.models", sys)
    assert forbidden_modules() == ["yolo_scratch_tpu"]


def test_a_harness_process_loads_no_jax():
    """Importing every module the harness and the program's paths use loads
    none of the forbidden names."""
    code = ("import sys\n"
            "import benchmark.run, benchmark.control, benchmark.drivers.deploy, "
            "benchmark.drivers.train\n"
            "import yolo_scratch_tpu_torch.infer, yolo_scratch_tpu_torch.train.steps\n"
            "from benchmark.run import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
