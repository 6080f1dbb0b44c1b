"""The program's side of each family: ``programs/<family>.py`` builds the
program's model of a configuration and, for a family with train cells, its
train step (the contract: ``benchmark/spec.py``). These files may import
the program; nothing under ``reference/`` imports them."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Mapping

from benchmark.reference import require_family


def family(cfg: Mapping[str, Any]) -> ModuleType:
    """``programs/<family>.py`` of a configuration."""
    require_family(cfg["family"])
    return importlib.import_module(f"{__name__}.{cfg['family']}")
