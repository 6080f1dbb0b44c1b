"""Build native code (CUDA kernels, the host image library) at first use.

Outputs go to ``yolo_scratch_tpu_torch/build/`` (gitignored), never next to
the sources. Each library is compiled to a temporary name and renamed into
place, so concurrent builders never load a half-written file.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "build"

# sm_90a keeps Hopper-only instructions available. Whether nvcc may
# contract a*b+c into one FMA is each library's choice (``extra_flags``).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _stale(out: Path, sources: Sequence[Path]) -> bool:
    return not out.exists() or any(out.stat().st_mtime < s.stat().st_mtime for s in sources)


def compile_library(cmd: Sequence[str], out: Path, sources: Sequence[Path],
                    timeout: float = 600) -> Path:
    """Run ``cmd + ['-o', tmp]`` unless ``out`` is newer than every source;
    raise with the compiler's output on failure."""
    if not _stale(out, sources):
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {out.name} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_cuda_library(name: str, sources: Sequence[Path],
                       extra_flags: Sequence[str] = ()) -> Path:
    """nvcc ``sources`` into ``build/lib{name}.so`` (plain C interface), with
    ``extra_flags`` after the common ones."""
    return compile_library([find_nvcc(), *NVCC_FLAGS, *extra_flags, *map(str, sources)],
                           BUILD_DIR / f"lib{name}.so", sources)
