"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
checkout's root. CPU tests run the harness at small sizes on the plain
paths; tests marked ``gpu`` skip where no CUDA device is visible."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
