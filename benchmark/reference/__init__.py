"""The plain reference: plain ``torch``, nothing of the measured program.

A configuration's ``family`` names ``reference/<family>.py`` here and
``programs/<family>.py`` beside it (the contract: ``benchmark/spec.py``).
A family module may reuse the blocks of ``nets.py`` and the functions of
``post.py`` by relative import; it imports nothing from outside this
package but ``torch``, ``numpy`` and the standard library.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Any, Mapping

HERE = Path(__file__).resolve().parent
#: modules of this package that no family may be named after
OWN = frozenset({"nets", "post", "train"})


def require_family(fam: str) -> None:
    """Raise, naming both files a family needs, where either is missing."""
    files = (HERE / f"{fam}.py", HERE.parent / "programs" / f"{fam}.py")
    missing = [f for f in files if not f.is_file()]
    if missing or not fam.isidentifier() or fam in OWN:
        raise LookupError(
            f"family {fam!r} needs benchmark/reference/{fam}.py and benchmark/programs/{fam}.py"
            f" (missing: {', '.join(str(f.relative_to(HERE.parent)) for f in missing) or '-'};"
            f" a family is a Python name other than {sorted(OWN)})")


def family(cfg: Mapping[str, Any]) -> ModuleType:
    """``reference/<family>.py`` of a configuration."""
    require_family(cfg["family"])
    return importlib.import_module(f"{__name__}.{cfg['family']}")
