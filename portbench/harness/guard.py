"""The import guard: the port is measured, never the JAX package it was
ported from, so no module of JAX, of Flax or of that package may be loaded
in a run's process. A module's top-level name (the part before the first
dot) is compared whole: `madaiemulator_tpu_torch` is the port and passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "madaiemulator_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
