"""Refuse to measure with JAX or the JAX package loaded.

A module counts by its top-level name (the part before the first dot),
compared whole: ``repro_torch`` is the port and passes, ``repro`` is the
JAX package and does not."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
