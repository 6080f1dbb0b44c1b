"""Import guard: the port and chip_smoke.py load neither JAX, flax nor the
JAX package (whose ``__init__`` pulls in JAX), so they run on a machine
that has only PyTorch; nor the JAX repo's root scripts (``bench.py``,
``__graft_entry__.py``) or ``scripts/``, which the port's benches and
``entry.py`` replace; nor orbax, tensorstore or ``zstandard``: the port
reads the JAX package's checkpoints with its own code, and its zstd decoder
links no libzstd."""

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
                                    "__graft_entry__", "scripts", "orbax", "tensorstore",
                                    "zstandard"))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 90, proc.stdout  # every module of the package was imported


def test_zstd_decoder_links_no_libzstd():
    """The decoder's shared library (``csrc/zstd_decode.cpp``, built with g++
    at first use) needs no libzstd: none in its ``DT_NEEDED`` entries (what
    ``ldd`` resolves) nor anywhere in the file."""
    from yolo_scratch_tpu_torch.utils import zstd

    zstd.load()
    needed = subprocess.run(["ldd", str(zstd.LIBRARY)], capture_output=True, text=True,
                            check=True).stdout
    assert "zstd" not in needed and "libstdc++" in needed, needed
    assert b"libzstd" not in zstd.LIBRARY.read_bytes()


def test_host_library_links_no_codec_library():
    """The host library (``data/native.py``: ``csrc/yst_host.cpp`` and the
    port's own inflate, PNG and JPEG decoders, built with g++ at first use)
    needs no libpng, libjpeg or zlib: none in its ``DT_NEEDED`` entries (what
    ``ldd`` resolves) nor anywhere in the file."""
    from yolo_scratch_tpu_torch.data import native

    native.load()
    needed = subprocess.run(["ldd", str(native.LIBRARY)], capture_output=True, text=True,
                            check=True).stdout
    for lib in ("png", "jpeg", "libz."):
        assert lib not in needed, needed
    assert "libstdc++" in needed, needed
    blob = native.LIBRARY.read_bytes()
    for name in (b"libpng", b"libjpeg", b"libz.so", b"png_image_", b"jpeg_read_header"):
        assert name not in blob, name


def test_port_builds_nothing_from_the_root_csrc():
    """The port compiles only its own sources (``yolo_scratch_tpu_torch/csrc``):
    no Python file of the port, nor ``chip_smoke.py``, forms a path into the
    JAX package's ``csrc/`` at the root, and no C++ source of the port
    includes a file from outside its own directory."""
    import re

    from yolo_scratch_tpu_torch.data import native
    from yolo_scratch_tpu_torch.utils import build, zstd

    own = REPO / "yolo_scratch_tpu_torch" / "csrc"
    for src in [*native.SOURCES, *native.HEADERS, zstd.SOURCE]:
        assert src.parent == own and src.exists(), src
    root_path = re.compile(r"""(PKG\s*\.\s*parent|REPO|ROOT|parent\s*\.\s*parent)\s*/\s*["']csrc""")
    for py in [*sorted((REPO / "yolo_scratch_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        assert not root_path.search(py.read_text()), py
    for src in sorted(own.iterdir()):
        if src.suffix in (".cpp", ".cu", ".h", ".cuh"):
            for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
                assert (own / inc).exists() and "/" not in inc, (src, inc)
    assert build.PKG / "csrc" == own
