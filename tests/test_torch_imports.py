"""Import guard: the port and chip_smoke.py load neither JAX, flax nor the
JAX package (whose ``__init__`` pulls in JAX), so they run on a machine
that has only PyTorch; nor the JAX repo's root scripts (``bench.py``,
``__graft_entry__.py``) or ``scripts/``, which the port's benches and
``entry.py`` replace."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

GUARD = r"""
import importlib, pkgutil, sys
import yolo_scratch_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main) and chip_smoke.KERNELS
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "yolo_scratch_tpu", "bench",
                                    "__graft_entry__", "scripts"))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 86, proc.stdout  # every module of the package was imported
