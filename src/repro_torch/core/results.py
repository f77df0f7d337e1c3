"""Shared result surface for executor + simulator engines (DESIGN.md §15).

Every engine in the repo — the cluster executor (model-time or wall-clock
backends) and the ``simulate_*`` Monte-Carlo engines — historically grew its
own result shape, and downstream readers (benchmarks, golden fixtures,
figure tooling) read them as ad-hoc dicts.  ``ResultMapping`` unifies that
access surface: a result dataclass that mixes it in is ALSO a read-only
``Mapping`` whose keys are the stable dataclass field names plus any legacy
aliases, so ``res["t_complete"]``, ``dict(res)``, and ``"ok" in res`` all
work without the reader knowing which engine produced the object.

Two field classes are distinguished (class attributes, consumed by the
differential suite and ``tools/bench_compare.check_executor``):

  * PAYLOAD_FIELDS — seed-deterministic outputs (decoded values, masks, row
    counts).  The wall-clock backend contract (DESIGN.md §15) is that these
    are BIT-identical across backends for the same seed.
  * TIMING_FIELDS — clock readings (model seconds or wall seconds depending
    on the backend).  Never comparable across backends; benchmarks gate
    only orderings and loose sanity bands on them.

Copied from ``repro.core.results``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import ClassVar


class ResultMapping(Mapping):
    """Read-only dict view over a result dataclass (legacy-reader shim).

    Subclasses may declare ``LEGACY_ALIASES`` (alias -> field name); aliased
    keys resolve but do not appear in ``keys()`` — new readers see only the
    stable names, old readers keep working.
    """

    LEGACY_ALIASES: ClassVar[dict[str, str]] = {}
    PAYLOAD_FIELDS: ClassVar[tuple[str, ...]] = ()
    TIMING_FIELDS: ClassVar[tuple[str, ...]] = ()

    def _field_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(self))

    def __getitem__(self, key: str):
        name = self.LEGACY_ALIASES.get(key, key)
        if name in self._field_names():
            return getattr(self, name)
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        # aliases resolve via [] but are not members: ``keys()`` (and the
        # default Mapping.__contains__, which would see aliased lookups
        # succeed) must advertise only the stable field names
        return key in self._field_names()

    def __iter__(self):
        return iter(self._field_names())

    def __len__(self) -> int:
        return len(self._field_names())

    def payload(self) -> dict:
        """The seed-deterministic fields (bit-identical across backends)."""
        return {k: getattr(self, k) for k in self.PAYLOAD_FIELDS}

    def timings(self) -> dict:
        """The clock fields (backend-specific; never compared bitwise)."""
        return {k: getattr(self, k) for k in self.TIMING_FIELDS}
